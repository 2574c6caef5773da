// Multi-tensor kernels of the EAST trainer's optimizer step: ASAM's (or
// SAM's) perturbation of every parameter, its restore, and the guarded
// clip -> SGD momentum trace -> learning-rate scale -> apply of the
// trainable ones, each over all the leaves in one or two launches.
//
// Replaces no Pallas kernel: the JAX package's optimizer is optax under
// jax.jit, which XLA fuses. The port ran the same arithmetic as Python loops
// of torch ops over the model's ~350 parameter tensors, about a dozen small
// kernels a leaf, whose launches and not their work set the step's pace.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (sum of squares: p and g; perturbation: p, g, saved and p; restore:
// saved and p; update: g, t, p, t and p), a few operations an element, far
// below the 67 TFLOP/s of the SMs outside the tensor cores.
//
// What the design does about it: the leaves are laid end to end in a
// virtual concatenation in which each leaf starts at a multiple of 4
// elements, cut into chunks of MT_CHUNK elements. A block walks whole
// chunks (grid-stride), and a chunk covers the pieces of every leaf that
// overlaps it: small leaves are packed many to a chunk, large ones split
// over many chunks. A piece whose tensors are all row-major and whose
// addresses are aligned to 4 elements is read and written 4 elements at a
// time (16 bytes for float32), with a scalar tail; any other one element at
// a time, MT_UNROLL loads in flight a thread either way. The leaves'
// pointers, offsets, sizes and layouts travel as the kernel's parameter
// (__grid_constant__, up to 32,764 bytes with CUDA 12.1 or later), so
// nothing is copied to the card and the host never waits for it: the
// gradients' addresses change every step.
//
// Layouts: the kernels walk every leaf in its row-major order. A tensor of
// a leaf may instead be an (O, C, H, W) tensor laid out as (O, H, W, C),
// channels_last, as autograd returns a KxK convolution's gradient for the
// detector's NHWC input; the kernels gather and scatter it through its
// layout (strided bit d of the leaf for its tensor d; c = C, hw = H·W). The
// gather stays within one output channel's slab, which the block's loads
// share through L1.
//
// Element types: float32, float64 and bfloat16, each computed as torch
// computes its elementwise ops: float32 and float64 in their own precision,
// bfloat16 in float32 rounded to bfloat16 after every operation (Num<T>).
//
// The norms: the sum of squares writes one double per chunk into a scratch
// array, with no atomics; each block of the kernel that needs the norm sums
// those partials itself in one fixed order, so every block, and every run,
// gets the same value. Squares are summed in double, so the norm is within
// a rounding of the float64 norm; it differs from the plain loops' sums
// only by their summation order.
//
// The elementwise arithmetic is optax's, in optax's order, one IEEE
// rounding an operation (__fmul_rn, __fadd_rn, __fdiv_rn and their double
// forms, and -fmad=false besides), as torch's own elementwise kernels round
// each operation of the plain loops: given the same norm, the kernels'
// results equal the plain loops' bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#define MT_MAX_LEAVES 512
#define MT_CHUNK 32768
#define MT_THREADS 256
#define MT_UNROLL 4

// element types of the C interface (ops/multi_tensor.DTYPES)
#define MT_F32 0
#define MT_F64 1
#define MT_BF16 2

// D tensors a leaf (the first is the parameter), each leaf's offset in the
// concatenation (off[n] is the end), its number of elements, and its
// layouts: bit d of strided[l] says tensor d is an (O, C, H·W) tensor
// stored as (O, H·W, C), with c = C and hw = H·W
template <int D>
struct Leaves {
  void* ptr[D][MT_MAX_LEAVES];
  long long off[MT_MAX_LEAVES + 1];
  int numel[MT_MAX_LEAVES];
  int c[MT_MAX_LEAVES];
  int hw[MT_MAX_LEAVES];
  unsigned char strided[MT_MAX_LEAVES];
  int n;
};

static_assert(sizeof(Leaves<3>) + 128 <= 32764, "kernel parameters over 32,764 bytes");

// T's arithmetic as torch's elementwise kernels do it: in M, each operation
// rounded to T
template <class T>
struct Num;

template <>
struct Num<float> {
  using M = float;
  static __device__ __forceinline__ M ld(float x) { return x; }
  static __device__ __forceinline__ float st(M x) { return x; }
  static __device__ __forceinline__ M mul(M a, M b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ M add(M a, M b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ M div(M a, M b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ M of(double x) { return (float)x; }  // a Python scalar
  static __device__ __forceinline__ M norm(double s) { return (float)s; }
};

template <>
struct Num<double> {
  using M = double;
  static __device__ __forceinline__ M ld(double x) { return x; }
  static __device__ __forceinline__ double st(M x) { return x; }
  static __device__ __forceinline__ M mul(M a, M b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ M add(M a, M b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ M div(M a, M b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ M of(double x) { return x; }
  static __device__ __forceinline__ M norm(double s) { return s; }
};

template <>
struct Num<__nv_bfloat16> {
  using M = float;  // torch's opmath type for bfloat16
  static __device__ __forceinline__ M r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  static __device__ __forceinline__ M ld(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 st(M x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ M mul(M a, M b) { return r(__fmul_rn(a, b)); }
  static __device__ __forceinline__ M add(M a, M b) { return r(__fadd_rn(a, b)); }
  static __device__ __forceinline__ M div(M a, M b) { return r(__fdiv_rn(a, b)); }
  static __device__ __forceinline__ M of(double x) { return (float)x; }
  static __device__ __forceinline__ M norm(double s) { return __bfloat162float(__double2bfloat16(s)); }
};

// 4 elements, loaded and stored as one (float4 for float32)
template <class T>
struct alignas(4 * sizeof(T)) V4 {
  T v[4];
};

template <class T>
__device__ __forceinline__ bool aligned4(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

// Where element i (row-major) of a leaf lies in an (O, C, H·W) tensor
// stored as (O, H·W, C).
__device__ __forceinline__ long long strided_at(long long i, int c, int hw) {
  const int slab = c * hw;
  const long long o = i / slab;
  const int r = (int)(i - o * slab);
  const int ci = r / hw;
  return o * slab + (long long)(r - ci * hw) * c + ci;
}

// Where element i (row-major) of a leaf lies in its tensor d, read once a
// piece from the leaf's table entry.
struct Layout {
  int strided, c, hw;
  __device__ __forceinline__ long long operator()(int d, long long i) const {
    return (strided >> d & 1) ? strided_at(i, c, hw) : i;
  }
};

template <int D>
__device__ __forceinline__ Layout layout(const Leaves<D>& L, int l) {
  return Layout{L.strided[l], L.c[l], L.hw[l]};
}

// Calls f(leaf, start, stop) for each leaf with elements in chunk c: the
// leaf's elements [start, stop) that lie in [c, c + 1) * MT_CHUNK of the
// concatenation. ops/multi_tensor.walk models this walk.
template <int D, class F>
__device__ __forceinline__ void for_pieces(const Leaves<D>& L, long long c, F f) {
  const long long lo = c * MT_CHUNK, hi = lo + MT_CHUNK;
  int a = 0, b = L.n - 1;  // the last leaf that starts at or before lo
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (L.off[m] <= lo) a = m; else b = m - 1;
  }
  for (int l = a; l < L.n && L.off[l] < hi; ++l) {
    const long long s = max(lo, L.off[l]) - L.off[l];
    const long long e = min(hi, L.off[l] + (long long)L.numel[l]) - L.off[l];
    if (s < e) f(l, s, e);
  }
}

// The block's threads over items [s, e): MT_UNROLL items a thread loaded
// (load(i) -> V) before any is stored (store(i, v)).
template <class V, class Load, class Store>
__device__ __forceinline__ void stream(long long s, long long e, Load load, Store store) {
  for (long long i0 = s + threadIdx.x; i0 < e; i0 += MT_UNROLL * (long long)blockDim.x) {
    V v[MT_UNROLL];
#pragma unroll
    for (int u = 0; u < MT_UNROLL; ++u) {
      const long long i = i0 + u * (long long)blockDim.x;
      if (i < e) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < MT_UNROLL; ++u) {
      const long long i = i0 + u * (long long)blockDim.x;
      if (i < e) store(i, v[u]);
    }
  }
}

// The end of the 4-element part of a piece: all of it when every tensor is
// row-major and every address at s aligned to 4 elements (s is a multiple
// of 4 by the layout), else none of it.
__device__ __forceinline__ long long vector_stop(long long s, long long e, bool aligned) {
  return aligned ? s + ((e - s) & ~3LL) : s;
}

// The sum of v over the block, in a fixed order, returned to every thread.
__device__ double block_total(double v, double* shm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // shm may still be read from the previous call
  if ((threadIdx.x & 31) == 0) shm[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += shm[i];
    shm[32] = t;
  }
  __syncthreads();
  return shm[32];
}

// sqrt of the sum of the chunks' partial sums, the same in every block
__device__ double partials_norm(const double* __restrict__ partials, int n, double* shm) {
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += partials[i];
  return sqrt(block_total(v, shm));
}

template <class T, int A>
__device__ __forceinline__ double square_term(T p, T g) {
  using N = Num<T>;
  const double x = A ? (double)N::mul(fabs(N::ld(p)), N::ld(g)) : (double)N::ld(g);
  return x * x;
}

template <class X>
struct Two { X p, g; };
template <class X>
struct Three { X p, g, t; };

// partials[c] = the sum over chunk c of (|p|·g)² (A = 1, ASAM) or g²
template <class T, int A>
__global__ void __launch_bounds__(MT_THREADS)
sumsq_kernel(const __grid_constant__ Leaves<2> L, long long chunks,
             double* __restrict__ partials) {
  __shared__ double shm[33];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    double acc = 0.0;
    for_pieces(L, c, [&](int l, long long s, long long e) {
      const T* __restrict__ P = static_cast<const T*>(L.ptr[0][l]);
      const T* __restrict__ G = static_cast<const T*>(L.ptr[1][l]);
      const Layout at = layout(L, l);
      const long long v = vector_stop(s, e, at.strided == 0 && aligned4(P + s) && aligned4(G + s));
      const V4<T>* P4 = reinterpret_cast<const V4<T>*>(P);
      const V4<T>* G4 = reinterpret_cast<const V4<T>*>(G);
      stream<Two<V4<T>>>(s >> 2, v >> 2,
                         [&](long long i) { return Two<V4<T>>{A ? P4[i] : V4<T>{}, G4[i]}; },
                         [&](long long, const Two<V4<T>>& x) {
                           acc += square_term<T, A>(x.p.v[0], x.g.v[0]) +
                                  square_term<T, A>(x.p.v[1], x.g.v[1]) +
                                  square_term<T, A>(x.p.v[2], x.g.v[2]) +
                                  square_term<T, A>(x.p.v[3], x.g.v[3]);
                         });
      stream<Two<T>>(v, e,
                     [&](long long i) { return Two<T>{A ? P[at(0, i)] : T{}, G[at(1, i)]}; },
                     [&](long long, const Two<T>& x) { acc += square_term<T, A>(x.p, x.g); });
    });
    const double t = block_total(acc, shm);
    if (threadIdx.x == 0) partials[c] = t;
  }
}

// p + e_w, e_w = ((p·p)·g)·scale (A = 1) or g·scale
template <class T, int A>
__device__ __forceinline__ T perturbed(T p_, T g_, typename Num<T>::M scale) {
  using N = Num<T>;
  const auto p = N::ld(p_), g = N::ld(g_);
  const auto e = A ? N::mul(N::mul(N::mul(p, p), g), scale) : N::mul(g, scale);
  return N::st(N::add(p, e));
}

// saved <- p; p <- p + e_w, scale = (1 / (norm + eps))·rho as torch
// computes rho / (norm + eps)
template <class T, int A>
__global__ void __launch_bounds__(MT_THREADS)
perturb_kernel(const __grid_constant__ Leaves<2> L, long long chunks, T* __restrict__ saved,
               const double* __restrict__ partials, int n_partials, double rho, double eps,
               T* norm_out) {
  using N = Num<T>;
  __shared__ double shm[33];
  const auto norm = N::norm(partials_norm(partials, n_partials, shm));
  const auto scale = N::mul(N::div(N::of(1.0), N::add(norm, N::of(eps))), N::of(rho));
  if (norm_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *norm_out = N::st(norm);
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    for_pieces(L, c, [&](int l, long long s, long long e) {
      T* __restrict__ P = static_cast<T*>(L.ptr[0][l]);
      const T* __restrict__ G = static_cast<const T*>(L.ptr[1][l]);
      T* __restrict__ S = saved + L.off[l];
      const Layout at = layout(L, l);
      const long long v = vector_stop(
          s, e, at.strided == 0 && aligned4(P + s) && aligned4(G + s) && aligned4(S + s));
      V4<T>* P4 = reinterpret_cast<V4<T>*>(P);
      const V4<T>* G4 = reinterpret_cast<const V4<T>*>(G);
      V4<T>* S4 = reinterpret_cast<V4<T>*>(S);
      stream<Two<V4<T>>>(s >> 2, v >> 2, [&](long long i) { return Two<V4<T>>{P4[i], G4[i]}; },
                         [&](long long i, const Two<V4<T>>& x) {
                           S4[i] = x.p;
                           V4<T> q;
#pragma unroll
                           for (int u = 0; u < 4; ++u) q.v[u] = perturbed<T, A>(x.p.v[u], x.g.v[u], scale);
                           P4[i] = q;
                         });
      stream<Two<T>>(v, e, [&](long long i) { return Two<T>{P[at(0, i)], G[at(1, i)]}; },
                     [&](long long i, const Two<T>& x) {
                       S[i] = x.p;
                       P[at(0, i)] = perturbed<T, A>(x.p, x.g, scale);
                     });
    });
  }
}

// p <- saved, bit for bit
template <class T>
__global__ void __launch_bounds__(MT_THREADS)
restore_kernel(const __grid_constant__ Leaves<1> L, long long chunks, const T* __restrict__ saved) {
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    for_pieces(L, c, [&](int l, long long s, long long e) {
      T* __restrict__ P = static_cast<T*>(L.ptr[0][l]);
      const T* __restrict__ S = saved + L.off[l];
      const Layout at = layout(L, l);
      const long long v = vector_stop(s, e, at.strided == 0 && aligned4(P + s) && aligned4(S + s));
      V4<T>* P4 = reinterpret_cast<V4<T>*>(P);
      const V4<T>* S4 = reinterpret_cast<const V4<T>*>(S);
      stream<V4<T>>(s >> 2, v >> 2, [&](long long i) { return S4[i]; },
                    [&](long long i, const V4<T>& x) { P4[i] = x; });
      stream<T>(v, e, [&](long long i) { return S[i]; },
                [&](long long i, const T& x) { P[at(0, i)] = x; });
    });
  }
}

struct UpdateArgs {
  double max_norm, momentum, step;  // step = -lr at the count before it increments
};

// (p, t) after the guard, the clip, the trace and the scaled apply of g
template <class T>
__device__ __forceinline__ void updated(T& p_, T& t_, T g_, bool finite, bool keep,
                                        typename Num<T>::M norm, const UpdateArgs& a) {
  using N = Num<T>;
  const auto g = N::ld(g_);
  const auto gg = finite ? g : N::of(0.0);  // a select: a NaN gradient must not survive
  const auto u = keep ? gg : N::mul(N::div(gg, norm), N::of(a.max_norm));
  const auto t = N::add(u, N::mul(N::of(a.momentum), N::ld(t_)));
  t_ = N::st(t);
  p_ = N::st(N::add(N::ld(p_), N::mul(N::of(a.step), N::ld(t_))));
}

// not inf, not NaN, for a loss of type kind (MT_F32, MT_F64 or MT_BF16)
__device__ __forceinline__ bool finite_loss(const void* loss, int kind) {
  if (kind == MT_F64) return isfinite(*static_cast<const double*>(loss));
  if (kind == MT_BF16) return isfinite(__bfloat162float(*static_cast<const __nv_bfloat16*>(loss)));
  return isfinite(*static_cast<const float*>(loss));
}

// g <- 0 unless the loss is finite; g <- norm < max ? g : (g / norm)·max;
// t <- g + momentum·t; p <- p + step·t
template <class T>
__global__ void __launch_bounds__(MT_THREADS)
update_kernel(const __grid_constant__ Leaves<3> L, long long chunks,
              const double* __restrict__ partials, int n_partials, const void* loss, int loss_kind,
              UpdateArgs a, T* norm_out) {
  using N = Num<T>;
  __shared__ double shm[33];
  const bool finite = finite_loss(loss, loss_kind);
  const auto total = N::norm(partials_norm(partials, n_partials, shm));
  const auto norm = finite ? total : N::of(0.0);  // the guarded gradients' norm
  const bool keep = norm < N::of(a.max_norm);
  if (norm_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *norm_out = N::st(norm);
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    for_pieces(L, c, [&](int l, long long s, long long e) {
      T* __restrict__ P = static_cast<T*>(L.ptr[0][l]);
      const T* __restrict__ G = static_cast<const T*>(L.ptr[1][l]);
      T* __restrict__ Tr = static_cast<T*>(L.ptr[2][l]);
      const Layout at = layout(L, l);
      const long long v = vector_stop(
          s, e, at.strided == 0 && aligned4(P + s) && aligned4(G + s) && aligned4(Tr + s));
      V4<T>* P4 = reinterpret_cast<V4<T>*>(P);
      const V4<T>* G4 = reinterpret_cast<const V4<T>*>(G);
      V4<T>* T4 = reinterpret_cast<V4<T>*>(Tr);
      stream<Three<V4<T>>>(s >> 2, v >> 2,
                           [&](long long i) { return Three<V4<T>>{P4[i], G4[i], T4[i]}; },
                           [&](long long i, Three<V4<T>> x) {
#pragma unroll
                             for (int u = 0; u < 4; ++u)
                               updated<T>(x.p.v[u], x.t.v[u], x.g.v[u], finite, keep, norm, a);
                             T4[i] = x.t;
                             P4[i] = x.p;
                           });
      stream<Three<T>>(v, e,
                       [&](long long i) {
                         return Three<T>{P[at(0, i)], G[at(1, i)], Tr[at(2, i)]};
                       },
                       [&](long long i, Three<T> x) {
                         updated<T>(x.p, x.t, x.g, finite, keep, norm, a);
                         Tr[at(2, i)] = x.t;
                         P[at(0, i)] = x.p;
                       });
    });
  }
}

// The table of one group of leaves from the host's arrays: D arrays of n
// addresses, n + 1 offsets, n sizes, the layouts (c, hw, strided bits).
template <int D>
static int fill(Leaves<D>* L, const unsigned long long* const* ptrs, const long long* off,
                const int* numel, const int* c, const int* hw, const unsigned char* strided,
                int n) {
  if (n < 1 || n > MT_MAX_LEAVES) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < D; ++d)
    for (int i = 0; i < n; ++i) L->ptr[d][i] = reinterpret_cast<void*>(ptrs[d][i]);
  for (int i = 0; i <= n; ++i) L->off[i] = off[i];
  for (int i = 0; i < n; ++i) {
    L->numel[i] = numel[i];
    L->c[i] = c[i];
    L->hw[i] = hw[i];
    L->strided[i] = strided[i];
  }
  L->n = n;
  return 0;
}

// Blocks for a grid-stride walk of `chunks`: as many as fit on the card at
// once, at most one a chunk; each kernel's count found once.
static int grid_for(const void* kernel, long long chunks) {
  static std::mutex lock;
  static const void* kernels[32];
  static int blocks[32];
  static int known = 0;
  std::lock_guard<std::mutex> guard(lock);
  int b = 0;
  for (int i = 0; i < known && !b; ++i)
    if (kernels[i] == kernel) b = blocks[i];
  if (!b) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MT_THREADS, 0) != cudaSuccess)
      return 0;
    b = sms * (per_sm > 0 ? per_sm : 1);
    if (known < 32) {
      kernels[known] = kernel;
      blocks[known++] = b;
    }
  }
  return (int)(chunks < b ? chunks : b);
}

template <class... P, class... A>
static int launch(void (*kernel)(P...), long long chunks, void* stream, const A&... args) {
  const int grid = grid_for((const void*)kernel, chunks);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// F(T()) for the element type `dtype`
template <class F>
static int by_dtype(int dtype, F f) {
  switch (dtype) {
    case MT_F32: return f(float());
    case MT_F64: return f(double());
    case MT_BF16: return f(__nv_bfloat16());
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int multi_tensor_max_leaves() { return MT_MAX_LEAVES; }
extern "C" int multi_tensor_chunk() { return MT_CHUNK; }

// One group of leaves each, of element type dtype: p, g, t their addresses,
// c, hw and strided their layouts. The sum of squares writes partials from
// the group's first chunk's slot on; the others read all n_partials of them.
extern "C" int multi_tensor_sumsq(const unsigned long long* p, const unsigned long long* g,
                                  const long long* off, const int* numel, const int* c,
                                  const int* hw, const unsigned char* strided, int n,
                                  long long chunks, int dtype, int adaptive, double* partials,
                                  void* stream) {
  Leaves<2> L;
  const unsigned long long* ptrs[2] = {p, g};
  const int err = fill(&L, ptrs, off, numel, c, hw, strided, n);
  if (err) return err;
  return by_dtype(dtype, [&](auto x) {
    using T = decltype(x);
    return adaptive ? launch(sumsq_kernel<T, 1>, chunks, stream, L, chunks, partials)
                    : launch(sumsq_kernel<T, 0>, chunks, stream, L, chunks, partials);
  });
}

extern "C" int multi_tensor_perturb(const unsigned long long* p, const unsigned long long* g,
                                    const long long* off, const int* numel, const int* c,
                                    const int* hw, const unsigned char* strided, int n,
                                    long long chunks, int dtype, void* saved,
                                    const double* partials, int n_partials, double rho, double eps,
                                    int adaptive, void* norm_out, void* stream) {
  Leaves<2> L;
  const unsigned long long* ptrs[2] = {p, g};
  const int err = fill(&L, ptrs, off, numel, c, hw, strided, n);
  if (err) return err;
  return by_dtype(dtype, [&](auto x) {
    using T = decltype(x);
    T* s = static_cast<T*>(saved);
    T* o = static_cast<T*>(norm_out);
    return adaptive ? launch(perturb_kernel<T, 1>, chunks, stream, L, chunks, s, partials,
                             n_partials, rho, eps, o)
                    : launch(perturb_kernel<T, 0>, chunks, stream, L, chunks, s, partials,
                             n_partials, rho, eps, o);
  });
}

extern "C" int multi_tensor_restore(const unsigned long long* p, const long long* off,
                                    const int* numel, const int* c, const int* hw,
                                    const unsigned char* strided, int n, long long chunks,
                                    int dtype, const void* saved, void* stream) {
  Leaves<1> L;
  const unsigned long long* ptrs[1] = {p};
  const int err = fill(&L, ptrs, off, numel, c, hw, strided, n);
  if (err) return err;
  return by_dtype(dtype, [&](auto x) {
    using T = decltype(x);
    return launch(restore_kernel<T>, chunks, stream, L, chunks, static_cast<const T*>(saved));
  });
}

extern "C" int multi_tensor_update(const unsigned long long* p, const unsigned long long* g,
                                   const unsigned long long* t, const long long* off,
                                   const int* numel, const int* c, const int* hw,
                                   const unsigned char* strided, int n, long long chunks,
                                   int dtype, const double* partials, int n_partials,
                                   const void* loss, int loss_kind, double max_norm,
                                   double momentum, double step, void* norm_out, void* stream) {
  Leaves<3> L;
  const unsigned long long* ptrs[3] = {p, g, t};
  const int err = fill(&L, ptrs, off, numel, c, hw, strided, n);
  if (err) return err;
  return by_dtype(dtype, [&](auto x) {
    using T = decltype(x);
    return launch(update_kernel<T>, chunks, stream, L, chunks, partials, n_partials, loss,
                  loss_kind, UpdateArgs{max_norm, momentum, step}, static_cast<T*>(norm_out));
  });
}
