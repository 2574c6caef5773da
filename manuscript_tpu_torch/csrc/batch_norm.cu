// Train-mode BatchNorm with an optional residual and ReLU (K7):
// y = act(BN(x) + r), BN(x) = (x - mean)·(invstd·weight) + bias, with the
// batch mean and the biased batch variance over every axis but the
// channels', invstd = 1/sqrt(var + eps), act ReLU or the identity. Forward
// in two launches (statistics, apply), backward in two (the per-channel
// sums of the gradient, apply).
//
// Replaces no Pallas kernel: the JAX package's BatchNorm is flax's, which
// XLA fuses under jax.jit. The port ran it eagerly as ~37 composed ops a
// layer and pass (mean, subtract, square, mean, rsqrt, multiplies, adds, the
// running update, the ReLU and the residual add, and autograd's backward of
// each), every one a full pass over the activation, most of them broadcast
// kernels that channels_last tensors keep off torch's vectorized path.
//
// What bounds it on an H100: bytes. A few operations an element against a
// read or a write of it. The forward reads x twice, once for the statistics
// and once for the apply (with r), and writes y; the backward reads g and x
// twice (the sums, then the apply) and writes dx (and dr). Under the ReLU
// the backward's mask is BN(x) <= 0, recomputed from x with the forward's
// own rounding, so y is read only beside a residual.
//
// What the design does about it: each pass is one streaming kernel with
// 16-byte loads along the contiguous axis and BN_UNROLL loads in flight a
// thread, its grid one wave of the blocks that fit on the card; a second
// pass walks each block's span from the end, where the first finished, so
// it starts on what the 50 MB L2 cache still holds. Two layouts, as the
// models hand them in:
//
// * rows: an (M, C) matrix with the channels contiguous (a channels_last
//   N·H·W × C activation, or a 2-D (N, C) batch). A block is tc threads
//   along a chunk of tc·VEC channels by 256/tc along the rows, and walks a
//   span of rows; every thread keeps the same VEC channels.
// * planes: a row-major (N, C, S...) tensor, each channel N runs of S
//   contiguous elements. A block walks a span of one channel's vectors.
//
// Statistics are Welford's (count, mean, M2), never E[x²] - E[x]², of the
// channel's elements less its first one, a shift that keeps the means near
// zero where a channel's mean dwarfs its spread (float32 merges of means
// near 1e4 lose 1e-4 of the variance): a thread's loads are merged as a
// group into its running triple with Chan's formula, the block's threads
// pairwise in a fixed order, and each block writes its triple to a scratch
// array. The last block of a channel chunk
// to finish (an atomic ticket, atomicInc, which wraps back to 0 for the
// next launch; each stream has its own counters) merges the blocks' partials in a fixed order, writes mean
// and invstd, and moves the running statistics as flax does,
// running = momentum·running + (1 - momentum)·batch. The backward's sums
// Σg' and Σg'·x̂ (g' = g·[y > 0] under ReLU) are partials merged the same
// way. No float atomics anywhere: the grid is a function of the shape and
// the card, so every result repeats bit for bit.
//
// The backward's apply: dx = (weight·invstd)·(g' - Σg'/M - x̂·Σg'x̂/M), and
// dr = g' when there is a residual; Σg'x̂ and Σg' are dweight and dbias.
//
// Element types: float32 and bfloat16 computed in float32, float64 in
// float64; the per-channel vectors (weight, bias, running statistics, mean,
// invstd, dweight, dbias) are float32, or float64 for float64 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define BN_THREADS 256
#define BN_UNROLL 4
#define BN_PREFETCH 8  // partials a thread of the last block loads at once

// element types of the C interface (ops/batch_norm.DTYPES)
#define BN_F32 0
#define BN_F64 1
#define BN_BF16 2

template <class T>
struct Acc {
  using A = float;
};
template <>
struct Acc<double> {
  using A = double;
};

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_acc(typename Acc<T>::A x);
template <>
__device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <>
__device__ __forceinline__ double from_acc<double>(double x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 elements, loaded and stored as one (float4 for float32)
template <class T>
struct alignas(4 * sizeof(T)) V4 {
  T v[4];
};

// VEC consecutive elements of p from element i on, as A
template <int VEC, class T>
__device__ __forceinline__ void load(const T* __restrict__ p, long long i,
                                     typename Acc<T>::A* out) {
  if constexpr (VEC == 4) {
    const V4<T> q = *reinterpret_cast<const V4<T>*>(p + i);
#pragma unroll
    for (int u = 0; u < 4; ++u) out[u] = to_acc(q.v[u]);
  } else {
    out[0] = to_acc(p[i]);
  }
}

template <int VEC, class T>
__device__ __forceinline__ void store(T* __restrict__ p, long long i,
                                      const typename Acc<T>::A* in) {
  if constexpr (VEC == 4) {
    V4<T> q;
#pragma unroll
    for (int u = 0; u < 4; ++u) q.v[u] = from_acc<T>(in[u]);
    *reinterpret_cast<V4<T>*>(p + i) = q;
  } else {
    p[i] = from_acc<T>(in[0]);
  }
}

// How a launch cuts the tensor (ops/batch_norm.plan computes it).
struct Shape {
  long long O;     // rows (I == 1) or planes
  long long I;     // elements of a plane (1: an (O, C) matrix)
  long long nb;    // blocks along the reduced axis (gridDim.x)
  long long span;  // rows (rows) or vectors (planes) a block
  int C;
  int tc;  // rows: threads of a block along the channels, a power of 2 up to 32
};

// Where vector v of channel c lies in a planes tensor: plane o = v / iv,
// its vector i = v - o·iv.
template <int VEC>
__device__ __forceinline__ long long plane_at(long long v, long long iv, int c, const Shape& s) {
  const long long o = v / iv;
  return (o * s.C + c) * s.I + (v - o * iv) * VEC;
}

// (na, ma, qa) <- (na, ma, qa) merged with (nb, mb, qb): Chan et al.'s
// pairwise update of a count, a mean and a sum of squared deviations (M2).
template <class A>
__device__ __forceinline__ void chan(long long& na, A& ma, A& qa, long long nb, A mb, A qb) {
  if (nb == 0) return;
  const long long n = na + nb;
  const A f = (A)nb / (A)n;
  const A d = mb - ma;
  ma += d * f;
  qa += qb + d * d * ((A)na * f);
  na = n;
}

// The block's slots as rows of `width`: slot (row, col) = row·width + col
// holds a count and K (mean, M2) pairs. Merges every row into row 0,
// pairwise in a fixed order.
template <class A, int K>
__device__ __forceinline__ void tree_stats(long long* sn, A* sm, A* sq, int width) {
  const int row = threadIdx.x / width;
  for (int s = BN_THREADS / width / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (row < s) {
      const int a = threadIdx.x, b = threadIdx.x + s * width;
      const long long na = sn[a], nb = sn[b];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        long long n = na;
        chan(n, sm[a * K + k], sq[a * K + k], nb, sm[b * K + k], sq[b * K + k]);
      }
      sn[a] = na + nb;
    }
  }
  __syncthreads();
}

// The same for K pairs of sums (s1, s2) a slot.
template <class A, int K>
__device__ __forceinline__ void tree_sums(A* s1, A* s2, int width) {
  const int row = threadIdx.x / width;
  for (int s = BN_THREADS / width / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (row < s) {
      const int a = threadIdx.x, b = threadIdx.x + s * width;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s1[a * K + k] += s1[b * K + k];
        s2[a * K + k] += s2[b * K + k];
      }
    }
  }
  __syncthreads();
}

// Whether this block is the last of `blocks` to pass its ticket; the
// ticket is back at 0 once all have. Every thread's writes before it are
// visible to the last block.
__device__ __forceinline__ bool last_block(unsigned* ticket, unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, blocks - 1) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// What the statistics' last block writes.
template <class A>
struct Finish {
  A* mean;
  A* invstd;
  A* run_mean;  // null: the running statistics stay
  A* run_var;
  double momentum, eps;
};

// The last block: merges `parts` partial triples (count(p) elements each)
// of channels [cf, cf + lanes) in a fixed order, then writes mean (the
// shift x[c·I] added back), invstd and the running update. Lane l of group
// g merges parts g, g + G, ..., BN_PREFETCH of them loaded at once.
template <class T, class A, class Count>
__device__ __forceinline__ void finish_stats(const T* x, long long I, const A* pm, const A* pq,
                                             long long parts, int C, int cf, int lanes,
                                             Count count, long long* sn, A* sm, A* sq,
                                             const Finish<A>& f) {
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes, G = BN_THREADS / lanes;
  const int c = cf + lane;
  long long n = 0;
  A m = 0, q = 0;
  if (c < C)
    for (long long p0 = g; p0 < parts; p0 += (long long)G * BN_PREFETCH) {
      A mv[BN_PREFETCH], qv[BN_PREFETCH];
#pragma unroll
      for (int u = 0; u < BN_PREFETCH; ++u) {
        const long long p = p0 + (long long)u * G;
        if (p < parts) {
          mv[u] = __ldcg(pm + p * C + c);
          qv[u] = __ldcg(pq + p * C + c);
        }
      }
#pragma unroll
      for (int u = 0; u < BN_PREFETCH; ++u) {
        const long long p = p0 + (long long)u * G;
        if (p < parts) chan(n, m, q, count(p), mv[u], qv[u]);
      }
    }
  __syncthreads();  // the slots may still be read by the block's own tree
  sn[threadIdx.x] = n;
  sm[threadIdx.x] = m;
  sq[threadIdx.x] = q;
  tree_stats<A, 1>(sn, sm, sq, lanes);
  if (g == 0 && c < C) {
    const A mean = to_acc(x[c * I]) + sm[lane], var = sq[lane] / (A)sn[lane];
    f.mean[c] = mean;
    f.invstd[c] = (A)1 / sqrt(var + (A)f.eps);
    if (f.run_mean != nullptr) {
      const A keep = (A)f.momentum, take = (A)(1.0 - f.momentum);
      f.run_mean[c] = keep * f.run_mean[c] + take * mean;
      f.run_var[c] = keep * f.run_var[c] + take * var;
    }
  }
}

// The same for the backward's sums: dbias = Σg', dweight = Σg'·x̂.
template <class A>
__device__ __forceinline__ void finish_sums(const A* p1, const A* p2, long long parts, int C,
                                            int cf, int lanes, A* s1, A* s2, A* dweight,
                                            A* dbias) {
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes, G = BN_THREADS / lanes;
  const int c = cf + lane;
  A a = 0, b = 0;
  if (c < C)
    for (long long p0 = g; p0 < parts; p0 += (long long)G * BN_PREFETCH) {
      A av[BN_PREFETCH], bv[BN_PREFETCH];
#pragma unroll
      for (int u = 0; u < BN_PREFETCH; ++u) {
        const long long p = p0 + (long long)u * G;
        if (p < parts) {
          av[u] = __ldcg(p1 + p * C + c);
          bv[u] = __ldcg(p2 + p * C + c);
        }
      }
#pragma unroll
      for (int u = 0; u < BN_PREFETCH; ++u) {
        if (p0 + (long long)u * G < parts) {
          a += av[u];
          b += bv[u];
        }
      }
    }
  __syncthreads();
  s1[threadIdx.x] = a;
  s2[threadIdx.x] = b;
  tree_sums<A, 1>(s1, s2, lanes);
  if (g == 0 && c < C) {
    dbias[c] = s1[lane];
    dweight[c] = s2[lane];
  }
}

// A channel's vectors as the kernels read them.
template <class A>
struct Params {
  const A* mean;
  const A* invstd;
  const A* weight;
  const A* bias;
};

// BN(x) before the residual: one rounding of (x - mean)·mul + bias, the
// same in the forward and in the backward's mask
template <class A>
__device__ __forceinline__ A normed(A x, A mu, A mul, A b) {
  return fma(x - mu, mul, b);
}

// The ReLU's gradient mask on g: none (mask 0), y <= 0 (mask 1: the saved
// output, with a residual), or BN(x) <= 0 recomputed from x (mask 2: no
// residual, so y is not read). NaN passes, as in torch's relu.
template <class A>
__device__ __forceinline__ A masked(A g, int mask, A y, A x, A mu, A mul, A b) {
  if (mask == 1) return y <= (A)0 ? (A)0 : g;
  if (mask == 2) return normed(x, mu, mul, b) <= (A)0 ? (A)0 : g;
  return g;
}

// Merges a group of k values (the first k of v, k >= 1) into a running
// (n, m, q): Chan's update with the group's reciprocal rk = 1/k and
// f = k/(n + k) found once for all of a thread's channels.
template <class A, int K>
__device__ __forceinline__ void merge_group(const A* v, int k, A rk, A f, A nf, A& m, A& q) {
  A sum = 0;
#pragma unroll
  for (int u = 0; u < K; ++u)
    if (u < k) sum += v[u];
  const A gm = sum * rk;
  A gq = 0;
#pragma unroll
  for (int u = 0; u < K; ++u)
    if (u < k) {
      const A d = v[u] - gm;
      gq += d * d;
    }
  const A d = gm - m;
  m += d * f;
  q += gq + d * d * nf;
}

// ---- rows: an (M, C) matrix, the channels contiguous ----
//
// Block (b, j) covers rows [b·span, (b + 1)·span) of channel chunk j; thread
// (ty, tx) keeps channels j·tc·VEC + tx·VEC + [0, VEC) and walks rows
// ty, ty + tr, ... of the span (tr = 256 / tc), BN_UNROLL of them loaded at
// once. The second passes (apply, grad) walk each span from its end, where
// the first pass finished: the L2 cache still holds what it read last.

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
stats_rows(const T* __restrict__ x, Shape s, typename Acc<T>::A* __restrict__ pm,
           typename Acc<T>::A* __restrict__ pq, unsigned* __restrict__ tickets,
           Finish<typename Acc<T>::A> f) {
  using A = typename Acc<T>::A;
  __shared__ long long sn[BN_THREADS];
  __shared__ A sm[BN_THREADS * VEC], sq[BN_THREADS * VEC];
  const int tx = threadIdx.x % s.tc, ty = threadIdx.x / s.tc, tr = BN_THREADS / s.tc;
  const int c0 = (blockIdx.y * s.tc + tx) * VEC;
  const bool on = c0 < s.C;
  const long long r0 = (long long)blockIdx.x * s.span, r1 = min(s.O, r0 + s.span);
  long long n = 0;
  A m[VEC], q[VEC], k0[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) m[j] = q[j] = k0[j] = 0;
  if (on) {
    load<VEC>(x, c0, k0);  // the shift: row 0
    for (long long r = r0 + ty; r < r1; r += (long long)tr * BN_UNROLL) {
      A v[VEC][BN_UNROLL];
      int k = 0;
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const long long rr = r + (long long)u * tr;
        if (rr < r1) {
          A t[VEC];
          load<VEC>(x, rr * s.C + c0, t);
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j][u] = t[j] - k0[j];
          k = u + 1;
        }
      }
      const A rk = (A)1 / (A)k, f = (A)k / (A)(n + k), nf = (A)n * f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) merge_group<A, BN_UNROLL>(v[j], k, rk, f, nf, m[j], q[j]);
      n += k;
    }
  }
  sn[threadIdx.x] = n;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sm[threadIdx.x * VEC + j] = m[j];
    sq[threadIdx.x * VEC + j] = q[j];
  }
  tree_stats<A, VEC>(sn, sm, sq, s.tc);
  if (ty == 0 && on) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      pm[(long long)blockIdx.x * s.C + c0 + j] = sm[tx * VEC + j];
      pq[(long long)blockIdx.x * s.C + c0 + j] = sq[tx * VEC + j];
    }
  }
  if (!last_block(tickets + blockIdx.y, gridDim.x)) return;
  const long long rows = s.O, span = s.span;
  finish_stats(x, s.I, pm, pq, (long long)gridDim.x, s.C, blockIdx.y * s.tc * VEC, s.tc * VEC,
               [&](long long p) { return min(span, rows - p * span); }, sn, sm, sq, f);
}

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
apply_rows(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y, Shape s,
           Params<typename Acc<T>::A> p, int relu) {
  using A = typename Acc<T>::A;
  const int tx = threadIdx.x % s.tc, ty = threadIdx.x / s.tc, tr = BN_THREADS / s.tc;
  const int c0 = (blockIdx.y * s.tc + tx) * VEC;
  if (c0 >= s.C) return;
  A mu[VEC], mul[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = p.mean[c0 + j];
    mul[j] = p.invstd[c0 + j] * p.weight[c0 + j];
    b[j] = p.bias[c0 + j];
  }
  const long long r0 = (long long)blockIdx.x * s.span, r1 = min(s.O, r0 + s.span);
  const long long back = r0 + r1 - 1;  // row i of the walk is row back - i
  for (long long row = r0 + ty; row < r1; row += (long long)tr * BN_UNROLL) {
    A xv[BN_UNROLL][VEC], rv[BN_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long rr = row + (long long)u * tr;
      if (rr < r1) {
        load<VEC>(x, (back - rr) * s.C + c0, xv[u]);
        if (r != nullptr) load<VEC>(r, (back - rr) * s.C + c0, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long rr = row + (long long)u * tr;
      if (rr < r1) {
        A o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          A t = normed(xv[u][j], mu[j], mul[j], b[j]);
          if (r != nullptr) t += rv[u][j];
          if (relu) t = t <= (A)0 ? (A)0 : t;  // NaN stays NaN, as torch's relu
          o[j] = t;
        }
        store<VEC>(y, (back - rr) * s.C + c0, o);
      }
    }
  }
}

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
sums_rows(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ y, Shape s,
          Params<typename Acc<T>::A> p, typename Acc<T>::A* __restrict__ p1,
          typename Acc<T>::A* __restrict__ p2, unsigned* __restrict__ tickets,
          typename Acc<T>::A* __restrict__ dweight, typename Acc<T>::A* __restrict__ dbias,
          int mask) {
  using A = typename Acc<T>::A;
  __shared__ A s1[BN_THREADS * VEC], s2[BN_THREADS * VEC];
  const int tx = threadIdx.x % s.tc, ty = threadIdx.x / s.tc, tr = BN_THREADS / s.tc;
  const int c0 = (blockIdx.y * s.tc + tx) * VEC;
  const bool on = c0 < s.C;
  A a[VEC], b[VEC], mu[VEC], is[VEC], mul[VEC], bias[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = b[j] = 0;
    mu[j] = on ? p.mean[c0 + j] : (A)0;
    is[j] = on ? p.invstd[c0 + j] : (A)0;
    mul[j] = on ? is[j] * p.weight[c0 + j] : (A)0;
    bias[j] = on ? p.bias[c0 + j] : (A)0;
  }
  const long long r0 = (long long)blockIdx.x * s.span, r1 = min(s.O, r0 + s.span);
  if (on)
    for (long long row = r0 + ty; row < r1; row += (long long)tr * BN_UNROLL) {
      A gv[BN_UNROLL][VEC], xv[BN_UNROLL][VEC], yv[BN_UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const long long rr = row + (long long)u * tr;
        if (rr < r1) {
          load<VEC>(g, rr * s.C + c0, gv[u]);
          load<VEC>(x, rr * s.C + c0, xv[u]);
          if (mask == 1) load<VEC>(y, rr * s.C + c0, yv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const long long rr = row + (long long)u * tr;
        if (rr < r1) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const A gp = masked(gv[u][j], mask, yv[u][j], xv[u][j], mu[j], mul[j], bias[j]);
            a[j] += gp;
            b[j] += gp * ((xv[u][j] - mu[j]) * is[j]);
          }
        }
      }
    }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s1[threadIdx.x * VEC + j] = a[j];
    s2[threadIdx.x * VEC + j] = b[j];
  }
  tree_sums<A, VEC>(s1, s2, s.tc);
  if (ty == 0 && on) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      p1[(long long)blockIdx.x * s.C + c0 + j] = s1[tx * VEC + j];
      p2[(long long)blockIdx.x * s.C + c0 + j] = s2[tx * VEC + j];
    }
  }
  if (!last_block(tickets + blockIdx.y, gridDim.x)) return;
  finish_sums(p1, p2, (long long)gridDim.x, s.C, blockIdx.y * s.tc * VEC, s.tc * VEC, s1, s2,
              dweight, dbias);
}

// What the backward's apply reads a channel besides its Params.
template <class A>
struct Back {
  const A* dweight;  // Σg'·x̂
  const A* dbias;    // Σg'
  A count;           // M, the elements a channel
};

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
grad_rows(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ y,
          T* __restrict__ dx, T* __restrict__ dr, Shape s, Params<typename Acc<T>::A> p,
          Back<typename Acc<T>::A> k, int mask) {
  using A = typename Acc<T>::A;
  const int tx = threadIdx.x % s.tc, ty = threadIdx.x / s.tc, tr = BN_THREADS / s.tc;
  const int c0 = (blockIdx.y * s.tc + tx) * VEC;
  if (c0 >= s.C) return;
  A mu[VEC], is[VEC], mul[VEC], bias[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = p.mean[c0 + j];
    is[j] = p.invstd[c0 + j];
    mul[j] = is[j] * p.weight[c0 + j];
    bias[j] = p.bias[c0 + j];
    a[j] = k.dbias[c0 + j] / k.count;
    b[j] = k.dweight[c0 + j] / k.count;
  }
  const bool need_x = dx != nullptr || mask == 2;
  const long long r0 = (long long)blockIdx.x * s.span, r1 = min(s.O, r0 + s.span);
  const long long back = r0 + r1 - 1;
  for (long long row = r0 + ty; row < r1; row += (long long)tr * BN_UNROLL) {
    A gv[BN_UNROLL][VEC], xv[BN_UNROLL][VEC], yv[BN_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long rr = row + (long long)u * tr;
      if (rr < r1) {
        const long long at = (back - rr) * s.C + c0;
        load<VEC>(g, at, gv[u]);
        if (need_x) load<VEC>(x, at, xv[u]);
        if (mask == 1) load<VEC>(y, at, yv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long rr = row + (long long)u * tr;
      if (rr < r1) {
        const long long at = (back - rr) * s.C + c0;
        A o[VEC], gp[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          gp[j] = masked(gv[u][j], mask, yv[u][j], xv[u][j], mu[j], mul[j], bias[j]);
          o[j] = mul[j] * ((gp[j] - a[j]) - ((xv[u][j] - mu[j]) * is[j]) * b[j]);
        }
        if (dx != nullptr) store<VEC>(dx, at, o);
        if (dr != nullptr) store<VEC>(dr, at, gp);
      }
    }
  }
}

// ---- planes: a row-major (N, C, S) tensor; a block walks one channel ----
//
// Block (b, c) covers vectors [b·span, (b + 1)·span) of channel c, vector v
// the VEC elements at plane_at(v); its threads take consecutive vectors,
// BN_UNROLL each at once. The second passes walk each span from its end.

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
stats_planes(const T* __restrict__ x, Shape s, typename Acc<T>::A* __restrict__ pm,
             typename Acc<T>::A* __restrict__ pq, unsigned* __restrict__ tickets,
             Finish<typename Acc<T>::A> f) {
  using A = typename Acc<T>::A;
  __shared__ long long sn[BN_THREADS];
  __shared__ A sm[BN_THREADS], sq[BN_THREADS];
  const int c = blockIdx.y;
  const long long iv = s.I / VEC, ev = s.O * iv;
  const long long v0 = (long long)blockIdx.x * s.span, v1 = min(ev, v0 + s.span);
  const A k0 = to_acc(x[c * s.I]);  // the shift: the channel's first element
  long long n = 0;
  A m = 0, q = 0;
  for (long long v = v0 + threadIdx.x; v < v1; v += (long long)BN_THREADS * BN_UNROLL) {
    A t[BN_UNROLL * VEC];
    int k = 0;
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long vv = v + (long long)u * BN_THREADS;
      if (vv < v1) {
        load<VEC>(x, plane_at<VEC>(vv, iv, c, s), t + u * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) t[u * VEC + j] -= k0;
        k = (u + 1) * VEC;
      }
    }
    const A rk = (A)1 / (A)k, f = (A)k / (A)(n + k), nf = (A)n * f;
    merge_group<A, BN_UNROLL * VEC>(t, k, rk, f, nf, m, q);
    n += k;
  }
  sn[threadIdx.x] = n;
  sm[threadIdx.x] = m;
  sq[threadIdx.x] = q;
  tree_stats<A, 1>(sn, sm, sq, 1);
  if (threadIdx.x == 0) {
    pm[(long long)blockIdx.x * s.C + c] = sm[0];
    pq[(long long)blockIdx.x * s.C + c] = sq[0];
  }
  if (!last_block(tickets + c, gridDim.x)) return;
  const long long span = s.span;
  finish_stats(x, s.I, pm, pq, (long long)gridDim.x, s.C, c, 1,
               [&](long long p) { return min(span, ev - p * span) * VEC; }, sn, sm, sq, f);
}

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
apply_planes(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y, Shape s,
             Params<typename Acc<T>::A> p, int relu) {
  using A = typename Acc<T>::A;
  const int c = blockIdx.y;
  const A mu = p.mean[c], mul = p.invstd[c] * p.weight[c], b = p.bias[c];
  const long long iv = s.I / VEC, ev = s.O * iv;
  const long long v0 = (long long)blockIdx.x * s.span, v1 = min(ev, v0 + s.span);
  const long long back = v0 + v1 - 1;
  for (long long v = v0 + threadIdx.x; v < v1; v += (long long)BN_THREADS * BN_UNROLL) {
    A xv[BN_UNROLL][VEC], rv[BN_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long vv = v + (long long)u * BN_THREADS;
      if (vv < v1) {
        const long long at = plane_at<VEC>(back - vv, iv, c, s);
        load<VEC>(x, at, xv[u]);
        if (r != nullptr) load<VEC>(r, at, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long vv = v + (long long)u * BN_THREADS;
      if (vv < v1) {
        A o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          A t = normed(xv[u][j], mu, mul, b);
          if (r != nullptr) t += rv[u][j];
          if (relu) t = t <= (A)0 ? (A)0 : t;
          o[j] = t;
        }
        store<VEC>(y, plane_at<VEC>(back - vv, iv, c, s), o);
      }
    }
  }
}

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
sums_planes(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ y, Shape s,
            Params<typename Acc<T>::A> p, typename Acc<T>::A* __restrict__ p1,
            typename Acc<T>::A* __restrict__ p2, unsigned* __restrict__ tickets,
            typename Acc<T>::A* __restrict__ dweight, typename Acc<T>::A* __restrict__ dbias,
            int mask) {
  using A = typename Acc<T>::A;
  __shared__ A s1[BN_THREADS], s2[BN_THREADS];
  const int c = blockIdx.y;
  const A mu = p.mean[c], is = p.invstd[c], mul = is * p.weight[c], bias = p.bias[c];
  const long long iv = s.I / VEC, ev = s.O * iv;
  const long long v0 = (long long)blockIdx.x * s.span, v1 = min(ev, v0 + s.span);
  A a = 0, b = 0;
  for (long long v = v0 + threadIdx.x; v < v1; v += (long long)BN_THREADS * BN_UNROLL) {
    A gv[BN_UNROLL][VEC], xv[BN_UNROLL][VEC], yv[BN_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long vv = v + (long long)u * BN_THREADS;
      if (vv < v1) {
        const long long at = plane_at<VEC>(vv, iv, c, s);
        load<VEC>(g, at, gv[u]);
        load<VEC>(x, at, xv[u]);
        if (mask == 1) load<VEC>(y, at, yv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long vv = v + (long long)u * BN_THREADS;
      if (vv < v1) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const A gp = masked(gv[u][j], mask, yv[u][j], xv[u][j], mu, mul, bias);
          a += gp;
          b += gp * ((xv[u][j] - mu) * is);
        }
      }
    }
  }
  s1[threadIdx.x] = a;
  s2[threadIdx.x] = b;
  tree_sums<A, 1>(s1, s2, 1);
  if (threadIdx.x == 0) {
    p1[(long long)blockIdx.x * s.C + c] = s1[0];
    p2[(long long)blockIdx.x * s.C + c] = s2[0];
  }
  if (!last_block(tickets + c, gridDim.x)) return;
  finish_sums(p1, p2, (long long)gridDim.x, s.C, c, 1, s1, s2, dweight, dbias);
}

template <class T, int VEC>
__global__ void __launch_bounds__(BN_THREADS)
grad_planes(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ dx, T* __restrict__ dr, Shape s, Params<typename Acc<T>::A> p,
            Back<typename Acc<T>::A> k, int mask) {
  using A = typename Acc<T>::A;
  const int c = blockIdx.y;
  const A mu = p.mean[c], is = p.invstd[c], mul = is * p.weight[c], bias = p.bias[c];
  const A a = k.dbias[c] / k.count, b = k.dweight[c] / k.count;
  const bool need_x = dx != nullptr || mask == 2;
  const long long iv = s.I / VEC, ev = s.O * iv;
  const long long v0 = (long long)blockIdx.x * s.span, v1 = min(ev, v0 + s.span);
  const long long back = v0 + v1 - 1;
  for (long long v = v0 + threadIdx.x; v < v1; v += (long long)BN_THREADS * BN_UNROLL) {
    A gv[BN_UNROLL][VEC], xv[BN_UNROLL][VEC], yv[BN_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long vv = v + (long long)u * BN_THREADS;
      if (vv < v1) {
        const long long at = plane_at<VEC>(back - vv, iv, c, s);
        load<VEC>(g, at, gv[u]);
        if (need_x) load<VEC>(x, at, xv[u]);
        if (mask == 1) load<VEC>(y, at, yv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long vv = v + (long long)u * BN_THREADS;
      if (vv < v1) {
        const long long at = plane_at<VEC>(back - vv, iv, c, s);
        A o[VEC], gp[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          gp[j] = masked(gv[u][j], mask, yv[u][j], xv[u][j], mu, mul, bias);
          o[j] = mul * ((gp[j] - a) - ((xv[u][j] - mu) * is) * b);
        }
        if (dx != nullptr) store<VEC>(dx, at, o);
        if (dr != nullptr) store<VEC>(dr, at, gp);
      }
    }
  }
}

// ---- the C interface ----

template <class... P, class... Args>
static int launch(void (*kernel)(P...), dim3 grid, void* stream, const Args&... args) {
  kernel<<<grid, BN_THREADS, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// f(T(), VEC) for the element type `dtype` and the load width `vec`
template <class F>
static int dispatch(int dtype, int vec, F f) {
  auto by_vec = [&](auto t) -> int {
    if (vec == 4) return f(t, std::integral_constant<int, 4>());
    if (vec == 1) return f(t, std::integral_constant<int, 1>());
    return (int)cudaErrorInvalidValue;
  };
  switch (dtype) {
    case BN_F32: return by_vec(float());
    case BN_F64: return by_vec(double());
    case BN_BF16: return by_vec(__nv_bfloat16());
    default: return (int)cudaErrorInvalidValue;
  }
}

static Shape shape_of(long long O, long long I, int C, int tc, long long nb, long long span) {
  Shape s;
  s.O = O;
  s.I = I;
  s.nb = nb;
  s.span = span;
  s.C = C;
  s.tc = tc;
  return s;
}

// rows (I == 1): chunks of tc·vec channels along y; planes: one channel a y
static dim3 grid_of(const Shape& s, int vec) {
  const long long y = s.I == 1 ? (s.C + (long long)s.tc * vec - 1) / ((long long)s.tc * vec) : s.C;
  return dim3((unsigned)s.nb, (unsigned)y);
}

template <class A>
static Params<A> params_of(const void* mean, const void* invstd, const void* weight,
                           const void* bias) {
  return Params<A>{static_cast<const A*>(mean), static_cast<const A*>(invstd),
                   static_cast<const A*>(weight), static_cast<const A*>(bias)};
}

extern "C" int batch_norm_threads() { return BN_THREADS; }
extern "C" int batch_norm_unroll() { return BN_UNROLL; }

// Blocks of kernel `which` (0 statistics, 1 apply, 2 gradient sums, 3
// gradient apply) of the layout that fit on one SM at once; -1 on an error.
extern "C" int batch_norm_occupancy(int planes, int dtype, int vec, int which) {
  return dispatch(dtype, vec, [&](auto t, auto v) -> int {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    const void* kernels[2][4] = {
        {(const void*)stats_rows<T, V>, (const void*)apply_rows<T, V>,
         (const void*)sums_rows<T, V>, (const void*)grad_rows<T, V>},
        {(const void*)stats_planes<T, V>, (const void*)apply_planes<T, V>,
         (const void*)sums_planes<T, V>, (const void*)grad_planes<T, V>}};
    if (which < 0 || which > 3) return -1;
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernels[planes ? 1 : 0][which],
                                                      BN_THREADS, 0) != cudaSuccess)
      return -1;
    return b;
  });
}

// The statistics: partials (pm, pq: nb × C each), then the last block of a
// chunk writes mean and invstd and, with run_mean and run_var given, the
// running update.
extern "C" int batch_norm_stats(const void* x, long long O, long long I, int C, int tc,
                                long long nb, long long span, int dtype, int vec, void* pm,
                                void* pq, unsigned* tickets, void* mean, void* invstd,
                                void* run_mean, void* run_var, double momentum, double eps,
                                void* stream) {
  const Shape s = shape_of(O, I, C, tc, nb, span);
  return dispatch(dtype, vec, [&](auto t, auto v) -> int {
    using T = decltype(t);
    using A = typename Acc<T>::A;
    constexpr int V = decltype(v)::value;
    const Finish<A> f{static_cast<A*>(mean), static_cast<A*>(invstd), static_cast<A*>(run_mean),
                      static_cast<A*>(run_var), momentum, eps};
    const T* X = static_cast<const T*>(x);
    A* PM = static_cast<A*>(pm);
    A* PQ = static_cast<A*>(pq);
    return I == 1 ? launch(stats_rows<T, V>, grid_of(s, V), stream, X, s, PM, PQ, tickets, f)
                  : launch(stats_planes<T, V>, grid_of(s, V), stream, X, s, PM, PQ, tickets, f);
  });
}

// y = act((x - mean)·(invstd·weight) + bias (+ r))
extern "C" int batch_norm_apply(const void* x, const void* r, void* y, long long O, long long I,
                                int C, int tc, long long nb, long long span, int dtype, int vec,
                                const void* mean, const void* invstd, const void* weight,
                                const void* bias, int relu, void* stream) {
  const Shape s = shape_of(O, I, C, tc, nb, span);
  return dispatch(dtype, vec, [&](auto t, auto v) -> int {
    using T = decltype(t);
    using A = typename Acc<T>::A;
    constexpr int V = decltype(v)::value;
    const Params<A> p = params_of<A>(mean, invstd, weight, bias);
    const T* X = static_cast<const T*>(x);
    const T* R = static_cast<const T*>(r);
    T* Y = static_cast<T*>(y);
    return I == 1 ? launch(apply_rows<T, V>, grid_of(s, V), stream, X, R, Y, s, p, relu)
                  : launch(apply_planes<T, V>, grid_of(s, V), stream, X, R, Y, s, p, relu);
  });
}

// dbias = Σg', dweight = Σg'·x̂ a channel, through partials (p1, p2: nb ×
// C); mask 0 (no ReLU), 1 (ReLU, y read) or 2 (ReLU, BN(x) recomputed)
extern "C" int batch_norm_grad_sums(const void* g, const void* x, const void* y, long long O,
                                    long long I, int C, int tc, long long nb, long long span,
                                    int dtype, int vec, const void* mean, const void* invstd,
                                    const void* weight, const void* bias, void* p1, void* p2,
                                    unsigned* tickets, void* dweight, void* dbias, int mask,
                                    void* stream) {
  const Shape s = shape_of(O, I, C, tc, nb, span);
  return dispatch(dtype, vec, [&](auto t, auto v) -> int {
    using T = decltype(t);
    using A = typename Acc<T>::A;
    constexpr int V = decltype(v)::value;
    const Params<A> p = params_of<A>(mean, invstd, weight, bias);
    const T* G = static_cast<const T*>(g);
    const T* X = static_cast<const T*>(x);
    const T* Y = static_cast<const T*>(y);
    A* P1 = static_cast<A*>(p1);
    A* P2 = static_cast<A*>(p2);
    A* DW = static_cast<A*>(dweight);
    A* DB = static_cast<A*>(dbias);
    return I == 1 ? launch(sums_rows<T, V>, grid_of(s, V), stream, G, X, Y, s, p, P1, P2,
                           tickets, DW, DB, mask)
                  : launch(sums_planes<T, V>, grid_of(s, V), stream, G, X, Y, s, p, P1, P2,
                           tickets, DW, DB, mask);
  });
}

// dx = (weight·invstd)·(g' - Σg'/M - x̂·Σg'x̂/M) and dr = g' (either may be null)
extern "C" int batch_norm_grad_apply(const void* g, const void* x, const void* y, void* dx,
                                     void* dr, long long O, long long I, int C, int tc,
                                     long long nb, long long span, int dtype, int vec,
                                     const void* mean, const void* invstd, const void* weight,
                                     const void* bias, const void* dweight, const void* dbias,
                                     int mask, void* stream) {
  const Shape s = shape_of(O, I, C, tc, nb, span);
  return dispatch(dtype, vec, [&](auto t, auto v) -> int {
    using T = decltype(t);
    using A = typename Acc<T>::A;
    constexpr int V = decltype(v)::value;
    const Params<A> p = params_of<A>(mean, invstd, weight, bias);
    const Back<A> k{static_cast<const A*>(dweight), static_cast<const A*>(dbias), (A)(O * I)};
    const T* G = static_cast<const T*>(g);
    const T* X = static_cast<const T*>(x);
    const T* Y = static_cast<const T*>(y);
    T* DX = static_cast<T*>(dx);
    T* DR = static_cast<T*>(dr);
    return I == 1 ? launch(grad_rows<T, V>, grid_of(s, V), stream, G, X, Y, DX, DR, s, p, k, mask)
                  : launch(grad_planes<T, V>, grid_of(s, V), stream, G, X, Y, DX, DR, s, p, k,
                           mask);
  });
}
