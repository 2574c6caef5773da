// The beam's advance (K8): one step of beam search over (B, k) beams and a
// vocabulary of V tokens, from the step's raw logits (B·k, V) float32 to the
// k beams each line keeps.
//
// For row r = line·k + j of the logits and each token c:
//   xs = x·(1/T)                                  T the temperature
//   lp = (xs - m_r) - log Σ_c exp(xs - m_r)       m_r = max_c xs
//   a finished beam continues only with EOS: lp = 0 there, -1e30 elsewhere
//   v  = (score_j + lp)·(1/L)                     L the GNMT length scale (1 at α = 0)
// and of each line's k·V values v the k largest, in descending order with
// ties to the lowest flat index j·V + c (jax.lax.top_k's rule, and a stable
// sort's), give parent = j, token = c, score = v·L and finished =
// finished[parent] | (token == EOS). The scalings are multiplications by the
// reciprocal, as PyTorch's CUDA division by a scalar computes them, and the
// log-softmax is written as PyTorch's CUDA log_softmax writes it; the file
// is built with -fmad=false, so no product is fused into the sum after it.
//
// Replaces no Pallas kernel: the JAX package's beam takes jax.lax.top_k and
// a log-softmax under XLA. The port ran it as ~20 composed ops a step, one of
// them a stable segmented radix sort of all B·k·V scores (with int64
// indices) just to keep k of each line, with six whole-matrix elementwise
// passes around it.
//
// What bounds it on an H100: bytes. A few operations a logit against reading
// it, and a row's log-sum-exp has to be known before any of its values, so
// the design reads the logits twice and caps near half of the bound that
// counts them once:
//
// * beam_lse: a block a row, each thread a running (max, Σ exp) over the
//   columns it owns whatever the row's alignment (so that equal rows give
//   equal sums, and a tie between beams stays a tie), merged across the
//   block in a fixed order → (m_r, log Σ) a row;
// * beam_top: a block a chunk of a line's k·V values (a line's rows are
//   contiguous, so a chunk is one run of memory), walked in the reverse of
//   beam_lse's order so that it starts on what the 50 MB L2 cache still
//   holds. Each thread keeps a sorted register list of its K best 64-bit
//   keys, the value's bits ordered as an unsigned integer above the inverted
//   index, so that one integer compare orders by value and then by index; a
//   float compare against the list's last value turns most values away
//   first. K rounds of a block-wide max give the block's K best. With
//   several chunks a line, each block writes its K keys to scratch and the
//   last block of the line to finish (an atomic ticket, atomicInc, which
//   wraps back to 0 for the next launch; each stream has its own counters)
//   merges them and writes the line's outputs.
//
// A finished beam's row is never read: its values are EOS at the beam's
// score and -1e30 below it everywhere else, so its EOS and its K lowest
// other tokens are all it can give. Where a line's k·V values are few
// (TRBA: 8 × 194), one block takes the whole line, computes its rows'
// log-sum-exp itself, a warp a row, and the step is one launch. The plan
// (ops/beam_select.py) sets the chunks from the lines and the card's SMs.
// Nothing of the (B·k, V) matrix is written, and no float atomics are
// used: a result repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BS_THREADS 256
#define BS_WARPS (BS_THREADS / 32)
#define BS_UNROLL 4  // 16-byte loads in flight a thread of the selection
#define BS_COLS 8    // 4-byte loads in flight a thread of the log-sum-exp
#define BS_KMAX 16   // the most beams a line
#define BS_NEG -1e30f

typedef unsigned long long u64;

// ---- log-sum-exp: (max, Σ exp(x - max)) of a run of values ----

struct Lse {
  float m, s;
};

__device__ __forceinline__ void lse_add(Lse& a, float x) {
  if (x > a.m) {
    a.s = a.s * expf(a.m - x) + 1.0f;
    a.m = x;
  } else {
    a.s += expf(x - a.m);
  }
}

__device__ __forceinline__ Lse lse_merge(Lse a, Lse b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  return Lse{m, (a.m == -INFINITY ? 0.0f : a.s * expf(a.m - m)) +
                    (b.m == -INFINITY ? 0.0f : b.s * expf(b.m - m))};
}

// every lane of the warp gets the merge of all 32
__device__ __forceinline__ Lse warp_lse(Lse a) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    a = lse_merge(a, Lse{__shfl_xor_sync(~0u, a.m, o), __shfl_xor_sync(~0u, a.s, o)});
  return a;
}

// Thread t of nt adds xs = x·inv_t of columns t, t + nt, ... of a row of V
// to a, in that order, BS_COLS loads in flight: a thread's columns and their
// order do not depend on where the row lies, so equal rows get equal sums.
__device__ __forceinline__ void row_lse(Lse& a, const float* __restrict__ row, unsigned V,
                                        float inv_t, unsigned t, unsigned nt) {
  for (unsigned c0 = t; c0 < V; c0 += BS_COLS * nt) {
    float buf[BS_COLS];
#pragma unroll
    for (int u = 0; u < BS_COLS; ++u) {
      const unsigned c = c0 + u * nt;
      if (c < V) buf[u] = __ldg(row + c);
    }
#pragma unroll
    for (int u = 0; u < BS_COLS; ++u)
      if (c0 + u * nt < V) lse_add(a, buf[u] * inv_t);
  }
}

// ---- the walk over a run of values ----

// f(i, x) for each value x = p[i], i in [lo, hi); thread t of nt takes every
// nt-th value, or 16-byte group between the run's first and last 16-byte
// boundaries, BS_UNROLL groups loaded before any is used.
template <class F>
__device__ __forceinline__ void walk(const float* __restrict__ p, unsigned lo, unsigned hi,
                                     unsigned t, unsigned nt, F&& f) {
  unsigned a = lo + (unsigned)(((16u - ((uintptr_t)(p + lo) & 15u)) & 15u) >> 2);
  if (a > hi) a = hi;
  const unsigned n4 = (hi - a) >> 2, b = a + 4 * n4;
  for (unsigned i = lo + t; i < a; i += nt) f(i, __ldg(p + i));
  for (unsigned i = b + t; i < hi; i += nt) f(i, __ldg(p + i));
  const float4* q = reinterpret_cast<const float4*>(p + a);
  for (unsigned v0 = t; v0 < n4; v0 += BS_UNROLL * nt) {
    float4 buf[BS_UNROLL];
#pragma unroll
    for (int u = 0; u < BS_UNROLL; ++u) {
      const unsigned v = v0 + u * nt;
      if (v < n4) buf[u] = __ldg(q + v);
    }
#pragma unroll
    for (int u = 0; u < BS_UNROLL; ++u) {
      const unsigned v = v0 + u * nt;
      if (v >= n4) break;
      const unsigned i = a + 4 * v;
      f(i, buf[u].x);
      f(i + 1, buf[u].y);
      f(i + 2, buf[u].z);
      f(i + 3, buf[u].w);
    }
  }
}

// ---- keys: value descending, then index ascending, as one unsigned order ----

__device__ __forceinline__ u64 key_of(float v, unsigned i) {
  v += 0.0f;  // -0 → +0: equal values get one key
  unsigned u = __float_as_uint(v);
  if (v != v) u = 0x7fc00000u;  // NaN above every number, as a descending sort puts it
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(0xffffffffu - i);
}

__device__ __forceinline__ float value_of(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned index_of(u64 key) { return 0xffffffffu - (unsigned)key; }

// A thread's K best keys, descending; 0 is an empty slot (no real key is 0:
// the index is below 2^32 - 1). thr is the last key's value, or -inf while
// a slot is empty: a value below it cannot enter.
template <int K>
struct Best {
  u64 key[K];
  float thr;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < K; ++i) key[i] = 0;
    thr = -INFINITY;
  }
  __device__ __forceinline__ void offer(float v, unsigned i) {
    if (!(v < thr)) push(key_of(v, i));  // NaN passes
  }
  __device__ __forceinline__ void push(u64 x) {
    if (x <= key[K - 1]) return;
    key[K - 1] = x;
#pragma unroll
    for (int i = K - 1; i > 0; --i) {
      const u64 a = key[i - 1], b = key[i];
      key[i - 1] = a > b ? a : b;
      key[i] = a > b ? b : a;
    }
    thr = key[K - 1] ? value_of(key[K - 1]) : -INFINITY;
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i < K - 1; ++i) key[i] = key[i + 1];
    key[K - 1] = 0;
  }
};

// The block's K best keys into out (shared), descending: K rounds of a
// block-wide max of the threads' heads, the winner dropping its head. Two
// buffers of warp maxima take turns, so one barrier a round keeps them apart.
template <int K>
__device__ __forceinline__ void block_best(Best<K>& b, u64* out) {
  __shared__ u64 red[2][BS_WARPS];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int r = 0; r < K; ++r) {
    const u64 h = b.key[0];
    u64 w = h;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const u64 y = __shfl_xor_sync(~0u, w, o);
      w = y > w ? y : w;
    }
    if (lane == 0) red[r & 1][warp] = w;
    __syncthreads();
    u64 top = red[r & 1][0];
#pragma unroll
    for (int q = 1; q < BS_WARPS; ++q) top = red[r & 1][q] > top ? red[r & 1][q] : top;
    if (h == top) b.pop();  // keys are unique, so one thread; all when every slot is empty
    if (threadIdx.x == 0) out[r] = top;
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

// ---- the kernels ----

// (m_r, log Σ exp(xs - m_r)) of each row r of (rows, V) whose beam has not
// finished (beam_top reads no other), a block a row
__global__ void __launch_bounds__(BS_THREADS)
    beam_lse(const float* __restrict__ x, const unsigned char* __restrict__ finished, unsigned V,
             float inv_t, float2* __restrict__ out) {
  __shared__ Lse part[BS_WARPS];
  if (finished[blockIdx.x]) return;
  Lse a{-INFINITY, 0.0f};
  row_lse(a, x + (size_t)blockIdx.x * V, V, inv_t, threadIdx.x, BS_THREADS);
  a = warp_lse(a);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    Lse t = part[0];
    for (int w = 1; w < BS_WARPS; ++w) t = lse_merge(t, part[w]);
    out[blockIdx.x] = make_float2(t.m, logf(t.s));
  }
}

struct Step {
  const float* x;                // (lines·k, V) logits
  const float2* lse;             // (lines·k) from beam_lse, or null: a block computes its line's
  const float* score;            // (lines, k) the beams' scores
  const unsigned char* finished; // (lines, k)
  unsigned lines, k, V, kv, chunk, chunks;  // chunk: values a block; chunks: blocks a line
  unsigned eos;
  float inv_t, inv_l, l;         // 1/T, 1/L, L
  u64* cand;                     // (lines, chunks, K) keys, with several chunks a line
  unsigned* tickets;             // one a line, with several chunks a line
  long long* ids;                // (2, lines, k): tokens, then parents
  float* out_score;              // (lines, k)
  unsigned char* out_finished;   // (lines, k)
};

template <int K>
__global__ void __launch_bounds__(BS_THREADS) beam_top(const Step s) {
  __shared__ float m[BS_KMAX], ls[BS_KMAX], sc[BS_KMAX];
  __shared__ unsigned char fin[BS_KMAX];
  __shared__ u64 best[K];
  // the reverse of beam_lse's order: the last lines first
  const unsigned blk = gridDim.x - 1 - blockIdx.x;
  const unsigned line = blk / s.chunks, chunk = blk % s.chunks;
  const float* xl = s.x + (size_t)line * s.kv;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < s.k) {
    const unsigned r = line * s.k + threadIdx.x;
    sc[threadIdx.x] = s.score[r];
    fin[threadIdx.x] = s.finished[r];
    if (s.lse) {
      const float2 e = s.lse[r];
      m[threadIdx.x] = e.x;
      ls[threadIdx.x] = e.y;
    }
  }
  __syncthreads();
  if (!s.lse) {
    for (unsigned j = warp; j < s.k; j += BS_WARPS) {
      if (fin[j]) continue;
      Lse a{-INFINITY, 0.0f};
      row_lse(a, xl + (size_t)j * s.V, s.V, s.inv_t, lane, 32);
      a = warp_lse(a);
      if (lane == 0) {
        m[j] = a.m;
        ls[j] = logf(a.s);
      }
    }
    __syncthreads();
  }

  // the chunk's values, row by row: a finished row's values need no logit
  // (EOS at the beam's score, every other token at -1e30 below it, so the
  // lowest K of them are all it can give), another row's need its
  // log-sum-exp and each logit
  Best<K> b;
  b.clear();
  const unsigned lo = chunk * s.chunk, hi = min(s.kv, lo + s.chunk);
  for (unsigned j = lo / s.V; j < s.k && j * s.V < hi; ++j) {
    const unsigned base = j * s.V, a = max(lo, base), e = min(hi, base + s.V);
    const float sj = sc[j];
    if (fin[j]) {
      if (threadIdx.x == 0) {
        if (base + s.eos >= a && base + s.eos < e)
          b.offer((sj + 0.0f) * s.inv_l, base + s.eos);
        const float other = (sj + BS_NEG) * s.inv_l;
        for (unsigned i = a, n = 0; i < e && n < K; ++i)
          if (i != base + s.eos) {
            b.offer(other, i);
            ++n;
          }
      }
      continue;
    }
    const float mj = m[j], lj = ls[j];
    walk(xl, a, e, threadIdx.x, BS_THREADS, [&](unsigned i, float v) {
      b.offer((sj + ((v * s.inv_t - mj) - lj)) * s.inv_l, i);
    });
  }
  block_best<K>(b, best);

  if (s.chunks > 1) {
    const size_t at = (size_t)line * s.chunks * K;
    if (threadIdx.x < K) s.cand[at + (size_t)chunk * K + threadIdx.x] = best[threadIdx.x];
    if (!last_block(s.tickets + line, s.chunks)) return;
    b.clear();
    for (unsigned q = threadIdx.x; q < s.chunks * K; q += BS_THREADS)
      b.push(__ldcg(s.cand + at + q));
    block_best<K>(b, best);
  }
  if (threadIdx.x < s.k) {
    const u64 key = best[threadIdx.x];
    const unsigned i = index_of(key), j = i / s.V, c = i - j * s.V;
    const unsigned r = line * s.k + threadIdx.x;
    s.ids[r] = c;
    s.ids[(size_t)s.lines * s.k + r] = j;
    s.out_score[r] = value_of(key) * s.l;
    s.out_finished[r] = fin[j] | (c == s.eos);
  }
}

// ---- the C interface (ops/beam_select.py) ----

extern "C" int beam_select_threads() { return BS_THREADS; }
extern "C" int beam_select_kmax() { return BS_KMAX; }

// (m, log Σ) of each of `rows` rows of V logits whose beam has not finished
// into lse (rows float2)
extern "C" int beam_select_lse(const void* x, const void* finished, long long rows, int V,
                               float temperature, void* lse, void* stream) {
  if (rows < 1 || rows >= 0x7fffffffLL || V < 1) return (int)cudaErrorInvalidValue;
  beam_lse<<<(unsigned)rows, BS_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(finished), (unsigned)V,
      1.0f / temperature, static_cast<float2*>(lse));
  return (int)cudaGetLastError();
}

template <int K>
static int launch_top(const Step& s, cudaStream_t stream) {
  beam_top<K><<<s.lines * s.chunks, BS_THREADS, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

// The k best of each line → ids (2, lines, k) int64 (tokens, then parents),
// scores and finished (lines, k). lse: beam_lse's output, or null (each
// block computes its line's: chunks must then be 1 for one read a line).
// K: a power of two, k <= K <= 16; chunk: values a block, chunks =
// ceil(k·V / chunk) blocks a line; cand: lines·chunks·K keys and tickets:
// lines counters at 0, both unread with one chunk a line.
extern "C" int beam_select_top(const void* x, const void* lse, const void* score,
                               const void* finished, long long lines, int k, int V, int eos,
                               float temperature, float scale, int K, long long chunk, int chunks,
                               void* cand, unsigned* tickets, void* ids, void* out_score,
                               void* out_finished, void* stream) {
  const long long kv = (long long)k * V;
  if (lines < 1 || k < 1 || k > K || V < 1 || eos < 0 || eos >= V || kv >= 0xffffffffLL ||
      chunks < 1 || chunk < 1 || (chunks - 1) * chunk >= kv || (long long)chunks * chunk < kv ||
      lines * chunks >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Step s;
  s.x = static_cast<const float*>(x);
  s.lse = static_cast<const float2*>(lse);
  s.score = static_cast<const float*>(score);
  s.finished = static_cast<const unsigned char*>(finished);
  s.lines = (unsigned)lines;
  s.k = (unsigned)k;
  s.V = (unsigned)V;
  s.kv = (unsigned)kv;
  s.chunk = (unsigned)chunk;
  s.chunks = (unsigned)chunks;
  s.eos = (unsigned)eos;
  s.inv_t = 1.0f / temperature;
  s.inv_l = 1.0f / scale;
  s.l = scale;
  s.cand = static_cast<u64*>(cand);
  s.tickets = tickets;
  s.ids = static_cast<long long*>(ids);
  s.out_score = static_cast<float*>(out_score);
  s.out_finished = static_cast<unsigned char*>(out_finished);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_top<1>(s, st);
    case 2: return launch_top<2>(s, st);
    case 4: return launch_top<4>(s, st);
    case 8: return launch_top<8>(s, st);
    case 16: return launch_top<16>(s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
