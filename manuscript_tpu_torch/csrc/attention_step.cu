// One TRBA attention-decoder step (additive attention + LSTM cell), fused.
//
// Replaces the TPU kernel manuscript_tpu/ops/pallas_attention.py:
// attention_lstm_step_pallas (body _step_kernel). Per beam row r:
//
//   proj_h = h·W_h2h + b_h2h
//   e_t    = tanh(proj_enc_t + proj_h)·w_score        t = 0..T-1
//   α      = softmax_t(e)                             (max subtracted first)
//   ctx    = Σ_t α_t·enc_t
//   z      = ctx·W_ih[:E] + W_ih[E + tok] + h·W_hh + bias     (gates i,f,g,o)
//   c'     = σ(z_f)·c + σ(z_i)·tanh(z_g),   h' = σ(z_o)·tanh(c')
//
// The Pallas kernel multiplies a one-hot row, padded to 128 classes, by the
// token block of W_ih; here that product is the row gather W_ih[E + tok],
// which is exact in f32 and reads 4H floats instead of V·4H.
//
// What bounds it on an H100: bytes. At the main path's R = 256 beam rows,
// T = 32, H = E = 256 a step reads 16.8 MB of enc/proj_enc (each once) plus
// 2.3 MB of weights, and does about 0.3 GFLOP of f32 work: ~5.7 us of HBM
// traffic against ~4.6 us of f32 arithmetic at the card's peak. Nothing here
// is large enough for the tensor cores.
//
// What the design does about it: a block takes ROWS beam rows (4 or 8) and
// one chunk of the hidden units, so each weight element it reads (from L2
// after the first block) feeds ROWS rows and the grid has 256 to 512 blocks
// at every beam-row count the page path uses (R = 256..2048). Each block computes the attention of its
// rows (proj_h, scores, α, ctx) and then the four gate columns of its units;
// enc/proj_enc rows are read once per block, coalesced, weight columns are
// read KT elements per batch of independent loads, every intermediate stays
// in shared memory or registers, and the T-long softmax is a warp reduction.
// The kernel is still far from its bound (PERF.md): with one block of 8 warps
// per SM its phases run as chains of dependent L2 round trips, and the
// attention is recomputed by each hidden-unit chunk. Splitting attention and
// gates into separate grids, wgmma/TMA for the gate products, and a CUDA
// graph over the decode loop are later work.

#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256
#define BLOCK_TARGET 512  // blocks the grid aims for (row groups × unit chunks)
#define KT 32  // weight elements per thread per batch of loads

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// acc[r] += Σ_k x[r·K + k] · w[k·ldw] over k < K, for the ROWS rows of x in
// shared memory and one weight column w in global memory. The column is read
// KT elements at a time into registers so that KT independent loads are in
// flight per thread; x is read as float4 (K is a multiple of 4).
template <int ROWS>
__device__ __forceinline__ void rows_dot_column(const float* __restrict__ x, int K,
                                                const float* __restrict__ w, int ldw,
                                                float acc[ROWS]) {
  int k0 = 0;
  for (; k0 + KT <= K; k0 += KT) {
    float wk[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) wk[kk] = w[(size_t)(k0 + kk) * ldw];
#pragma unroll
    for (int kk = 0; kk < KT; kk += 4) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + r * K + k0 + kk);
        acc[r] += xv.x * wk[kk];
        acc[r] += xv.y * wk[kk + 1];
        acc[r] += xv.z * wk[kk + 2];
        acc[r] += xv.w * wk[kk + 3];
      }
    }
  }
  for (; k0 < K; ++k0) {
    const float wk = w[(size_t)k0 * ldw];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] += x[r * K + k0] * wk;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS) attention_step_kernel(
    const float* __restrict__ enc,       // (R, T, E)
    const float* __restrict__ proj_enc,  // (R, T, H)
    const float* __restrict__ h,         // (R, H)
    const float* __restrict__ c,         // (R, H)
    const int* __restrict__ tok,         // (R,)
    const float* __restrict__ w_h2h,     // (H, H)
    const float* __restrict__ b_h2h,     // (H,)
    const float* __restrict__ w_score,   // (H,)
    const float* __restrict__ w_ih,      // (E + V, 4H)
    const float* __restrict__ w_hh,      // (H, 4H)
    const float* __restrict__ bias,      // (4H,)
    float* __restrict__ h_out,           // (R, H)
    float* __restrict__ c_out,           // (R, H)
    int R, int T, int H, int E) {
  extern __shared__ float smem[];
  float* s_h = smem;              // ROWS * H
  float* s_ph = s_h + ROWS * H;   // ROWS * H
  float* s_ctx = s_ph + ROWS * H; // ROWS * E
  float* s_a = s_ctx + ROWS * E;  // ROWS * T
  float* s_ws = s_a + ROWS * T;   // H: w_score
  float* s_z = s_ws + H;          // ROWS * 4 * (units of this block)

  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int H4 = 4 * H;

  for (int i = tid; i < ROWS * H; i += blockDim.x) {
    const int r = i / H;
    s_h[i] = r < nr ? h[(size_t)(r0 + r) * H + (i - r * H)] : 0.f;
  }
  for (int j = tid; j < H; j += blockDim.x) s_ws[j] = w_score[j];
  __syncthreads();

  // proj_h = h·W_h2h + b_h2h
  for (int j = tid; j < H; j += blockDim.x) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    rows_dot_column<ROWS>(s_h, H, w_h2h + j, H, acc);
    const float b = b_h2h[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s_ph[r * H + j] = acc[r] + b;
  }
  __syncthreads();

  // e[r, t]: one warp per (row, step) pair; each lane loads its 8 strided
  // proj_enc elements before using any, so the loads overlap
  for (int p = warp; p < nr * T; p += nwarps) {
    const int r = p / T, t = p - r * T;
    const float* pe = proj_enc + ((size_t)(r0 + r) * T + t) * H;
    const float* ph = s_ph + r * H;
    float acc = 0.f;
    int j = lane;
    for (; j + 7 * 32 < H; j += 8 * 32) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = pe[j + 32 * u];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += tanhf(v[u] + ph[j + 32 * u]) * s_ws[j + 32 * u];
    }
    for (; j < H; j += 32) acc += tanhf(pe[j] + ph[j]) * s_ws[j];
    acc = warp_sum(acc);
    if (lane == 0) s_a[r * T + t] = acc;
  }
  __syncthreads();

  // α = softmax over T, one warp per row
  for (int r = warp; r < nr; r += nwarps) {
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, s_a[r * T + t]);
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(s_a[r * T + t] - m);
      s_a[r * T + t] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int t = lane; t < T; t += 32) s_a[r * T + t] /= s;
  }
  __syncthreads();

  // ctx = Σ_t α_t·enc_t
  for (int i = tid; i < nr * E; i += blockDim.x) {
    const int r = i / E, e = i - r * E;
    const float* en = enc + (size_t)(r0 + r) * T * E + e;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) acc += s_a[r * T + t] * en[(size_t)t * E];
    s_ctx[r * E + e] = acc;
  }
  __syncthreads();

  // gate columns q·H + j of this block's units j ∈ [u0, u0 + per)
  const int per = (H + gridDim.y - 1) / gridDim.y;
  const int u0 = blockIdx.y * per;
  for (int i = tid; i < 4 * per; i += blockDim.x) {
    const int q = i / per, jj = i - q * per, j = u0 + jj;
    if (j >= H) continue;
    const int col = q * H + j;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    rows_dot_column<ROWS>(s_ctx, E, w_ih + col, H4, acc);
    rows_dot_column<ROWS>(s_h, H, w_hh + col, H4, acc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s_z[(r * 4 + q) * per + jj] = acc[r] + bias[col];
  }
  __syncthreads();

  // LSTM update of (row, unit) pairs; the token's input is the row W_ih[E+tok]
  for (int i = tid; i < nr * per; i += blockDim.x) {
    const int r = i / per, jj = i - r * per, j = u0 + jj;
    if (j >= H) continue;
    const size_t row = (size_t)(r0 + r);
    const float* wt = w_ih + ((size_t)E + tok[row]) * H4 + j;
    const float* z = s_z + r * 4 * per + jj;
    const float zi = z[0] + wt[0];
    const float zf = z[per] + wt[H];
    const float zg = z[2 * per] + wt[2 * H];
    const float zo = z[3 * per] + wt[3 * H];
    const float cn = sigmoidf(zf) * c[row * H + j] + sigmoidf(zi) * tanhf(zg);
    c_out[row * H + j] = cn;
    h_out[row * H + j] = sigmoidf(zo) * tanhf(cn);
  }
}

// Beam rows per block: 4 while the grid would otherwise be too small to fill
// the card, 8 above that so each weight element serves more rows (measured
// at R = 256..2048, PERF.md).
static int rows_per_block(int R) { return R <= 512 ? 4 : 8; }

// Hidden-unit chunks per row group: about BLOCK_TARGET blocks in all, at
// least 2 so the gate buffer stays small, at most 4.
static int n_chunks(int R) {
  const int groups = (R + rows_per_block(R) - 1) / rows_per_block(R);
  const int n = BLOCK_TARGET / (groups > 0 ? groups : 1);
  return n < 2 ? 2 : (n > 4 ? 4 : n);
}

extern "C" int attention_step_smem_bytes(int R, int T, int H, int E) {
  const int per = (H + n_chunks(R) - 1) / n_chunks(R);
  return (int)(sizeof(float) * (rows_per_block(R) * (2 * H + E + T + 4 * per) + H));
}

extern "C" int attention_step_launch(
    const float* enc, const float* proj_enc, const float* h, const float* c,
    const int* tok, const float* w_h2h, const float* b_h2h, const float* w_score,
    const float* w_ih, const float* w_hh, const float* bias, float* h_out,
    float* c_out, int R, int T, int H, int E, void* stream) {
  const int smem = attention_step_smem_bytes(R, T, H, E);
  const int rows = rows_per_block(R);
  const dim3 grid((R + rows - 1) / rows, n_chunks(R));
  if (rows == 4)
    attention_step_kernel<4><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias, h_out,
        c_out, R, T, H, E);
  else
    attention_step_kernel<8><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias, h_out,
        c_out, R, T, H, E);
  return (int)cudaGetLastError();
}
