// One TRBA attention-decoder step (additive attention + LSTM cell) as three
// grids: proj_h, attention, gates.
//
// Replaces the TPU kernel manuscript_tpu/ops/pallas_attention.py:116,
// attention_lstm_step_pallas (body _step_kernel). Beam row r = b·k + j is beam
// j of word b, and every beam of a word attends over that word's memory:
//
//   proj_h = h·W_h2h + b_h2h
//   e_t    = tanh(proj_enc[b]_t + proj_h)·w_score         t = 0..T-1
//   α      = softmax_t(e)                                  (max subtracted first)
//   ctx    = Σ_t α_t·enc[b]_t
//   z      = ctx·W_ih[:E] + W_ih[E + tok] + h·W_hh + bias  (gates i,f,g,o)
//   c'     = σ(z_f)·c + σ(z_i)·tanh(z_g),   h' = σ(z_o)·tanh(c')
//
// enc (B, T, E) and proj_enc (B, T, H) hold one row per word, not one per beam
// row: the JAX package repeats them k times before its decode loop, with the
// same values. The Pallas kernel multiplies a one-hot row, padded to 128
// classes, by the token block of W_ih; here that product is the row gather
// W_ih[E + tok], which is exact in f32 and reads 4H floats instead of V·4H.
//
// What bounds it on an H100: operations. At the main path's R = 256 beam rows
// (B = 32 words, k = 8), T = 32, H = E = 256 a step needs about 6 MB (the
// words' memory once, the weights, the states) against about 0.31 GFLOP, most
// of it the gate product [h | ctx]·[W_hh; W_ih[:E]] (R × 512 × 1024): ~1.8 us
// of HBM traffic against ~4.7 us of f32 arithmetic at the card's f32 peak.
//
// What the design does about it: three grids; the attention and gate grids
// are launched as programmatic dependents of the grid before them, so their
// blocks start (and read what does not depend on their predecessor) while the
// predecessor finishes.
//  - proj grid: proj_h = h·W_h2h + b_h2h for all R rows, a tiled product on
//    the tensor cores (tile_kernel<MODE_PROJ>), so W_h2h is read once per
//    64 columns and BM rows instead of once per word.
//  - attention grid: a cluster of CLUSTER blocks owns one word and all k of
//    its beams; block q of the cluster owns the q-th slice of the hidden units
//    (for the scores) and of the encoder features (for ctx). It brings its
//    slices of enc[b], proj_enc[b] and proj_h into shared memory with
//    cp.async, computes its partial scores and stores them into every block
//    of the cluster (distributed shared memory), so after one cluster barrier
//    each block has the word's full scores, takes the T-long softmax and
//    writes its slice of ctx to a scratch (R, E). A cluster spreads a word
//    over 4 SMs: at B = 32 words one block per word would leave 100 of 132
//    SMs idle.
//  - gate grid: [h | ctx]·[W_hh; W_ih[:E]] on the tensor cores
//    (tile_kernel<MODE_GATE>). A block computes a BM-row × (4 gates × UNITS
//    units) tile, so its epilogue holds the i, f, g and o sums of the same
//    units in the same thread and writes h' and c' directly; its sums start
//    from the token row W_ih[E + tok] plus the bias. The h half of the product
//    comes first and runs while the attention grid still works; the block
//    waits for ctx only before its first ctx tile.
// Both products use the 3xTF32 split to stay at float32 level (x = big +
// small, both TF32; a·b ≈ a_s·b_b + a_b·b_s + a_b·b_b, three
// mma.sync.m16n8k8 TF32 products accumulated in f32; single-pass TF32 moves h
// by about 1e-3), with three stages of cp.async tiles and the depth of each
// stage split between two groups of four warps. The split is a mask and a
// subtraction (split_tf32): with two roundings per operand the products were
// bound by issuing those instructions, not by the tensor cores.
// mma.sync rather than wgmma: at R ≤ 2048, K ≤ 512, N ≤ 1024 a product has
// 32–512 tiles of at most 64 × 64, few for wgmma's 64-row warpgroup tiles and
// a TMA pipeline on 132 SMs, and the split wants its A operand in registers;
// the gate product is now the largest part of the step (PERF.md), so wgmma
// with pre-split, pre-transposed weights is the next step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define ATT_THREADS 256
#define RCH 8  // beam rows per register batch of the ctx loop (written for 8)

#define GATE_THREADS 256  // 2 K-groups × (2 × 2 warps)
#define BK 64             // depth of a stage; each K-group takes one half
#define STAGES 3          // cp.async stages in flight
#define UNITS 16          // hidden units per gate tile: BN = 4 gates × UNITS
#define BN (4 * UNITS)    // columns of a tile (64 plain columns for proj_h)
#define LDA (BK + 4)      // padded rows: conflict-free fragment reads
#define LDB (BN + 8)

enum { MODE_PROJ = 0, MODE_GATE = 1 };

// ---- small helpers --------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// 16-byte copy to shared memory; bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small: big is x with the low 13 mantissa bits cleared (a TF32
// value), small = x - big exactly, which the tensor core reads as TF32 (it
// ignores the low 13 bits). Two instructions instead of two roundings; the
// split keeps about 21 of x's 24 bits in the three products.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a·b for one m16n8k8 TF32 tile, accumulated in f32
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Programmatic dependent launch: a grid lets its dependent start early; the
// dependent waits for the grid's results only where it first reads them.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- attention: one cluster per word ----------------------------------------

static_assert(RCH == 8, "the ctx loop keeps 8 rows in registers");

__host__ __device__ __forceinline__ int up4(int x) { return (x + 3) & ~3; }

// Shared memory of one attention block, offsets in floats (16-byte aligned);
// hs = H/S hidden units and es = E/S encoder features per block, beam rows
// padded to kp, a multiple of RCH.
struct AttLayout {
  int en, pe, ph, ws, part, at, red, total;
};

__host__ __device__ __forceinline__ AttLayout att_layout(int k, int T, int H, int E, int S) {
  const int hs = H / S, es = E / S, kp = (k + RCH - 1) / RCH * RCH;
  AttLayout L;
  int o = 0;
  L.en = o;   o += up4(T * es);                  // enc[b][:, e0:e0+es]
  L.pe = o;   o += up4(T * (hs + 1));            // proj_enc[b][:, h0:h0+hs], odd row stride
  L.ph = o;   o += up4(k * hs);                  // proj_h[rows of b][h0:h0+hs]
  L.ws = o;   o += up4(hs);                      // w_score slice
  L.part = o; o += up4(S * k * T);               // every block's partial scores
  L.at = o;   o += up4(T * kp);                  // α transposed
  L.red = o;  o += up4(ATT_THREADS / es * RCH * es);  // ctx partials
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(ATT_THREADS) attention_kernel(
    const float* __restrict__ enc,       // (B, T, E)
    const float* __restrict__ proj_enc,  // (B, T, H)
    const float* __restrict__ proj_h,    // (R, H), R = B·k, from the proj grid
    const float* __restrict__ w_score,   // (H,)
    float* __restrict__ ctx,             // (R, E) out
    int k, int T, int H, int E) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int hs = H / S, es = E / S, h0 = rank * hs, e0 = rank * es;
  const int ldp = hs + 1;
  const int kp = (k + RCH - 1) / RCH * RCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const AttLayout L = att_layout(k, T, H, E, S);
  launch_dependents();
  // first half of a cluster barrier: the blocks write into each other's
  // shared memory only after all of them have started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  extern __shared__ __align__(16) float smem[];
  float *s_en = smem + L.en, *s_pe = smem + L.pe, *s_ph = smem + L.ph, *s_ws = smem + L.ws;
  float *s_part = smem + L.part, *s_at = smem + L.at, *s_red = smem + L.red;

  // the word's memory slices (ready before the proj grid ends), then proj_h
  const float* peb = proj_enc + (size_t)b * T * H + h0;
  for (int i = tid; i < T * hs; i += ATT_THREADS) {
    const int t = i / hs, j = i - t * hs;
    cp_async4(s_pe + t * ldp + j, peb + (size_t)t * H + j);
  }
  const int eq = es / 4, hq = hs / 4;
  const float* enb = enc + (size_t)b * T * E + e0;
  for (int i = tid; i < T * eq; i += ATT_THREADS) {
    const int t = i / eq, j = 4 * (i - t * eq);
    cp_async16(s_en + t * es + j, enb + (size_t)t * E + j, 16);
  }
  for (int j = tid; j < hs; j += ATT_THREADS) s_ws[j] = w_score[h0 + j];
  wait_for_prerequisites();
  const float* phb = proj_h + (size_t)b * k * H + h0;
  for (int i = tid; i < k * hq; i += ATT_THREADS) {
    const int r = i / hq, j = 4 * (i - r * hq);
    cp_async16(s_ph + r * hs + j, phb + (size_t)r * H + j, 16);
  }
  cp_async_commit();
  for (int i = tid; i < T * (kp - k); i += ATT_THREADS) {
    const int t = i / (kp - k), r = k + i - t * (kp - k);
    s_at[t * kp + r] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // partial scores of this slice, thread per (row, step), stored into slot
  // `rank` of every block of the cluster
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int p = tid; p < k * T; p += ATT_THREADS) {
    const int r = p / T, t = p - r * T;
    const float* pe = s_pe + t * ldp;
    const float* ph = s_ph + r * hs;
    float acc = 0.f;
    for (int j = 0; j < hs; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(ph + j);
      const float4 w4 = *reinterpret_cast<const float4*>(s_ws + j);
      acc += tanhf(pe[j] + p4.x) * w4.x;
      acc += tanhf(pe[j + 1] + p4.y) * w4.y;
      acc += tanhf(pe[j + 2] + p4.z) * w4.z;
      acc += tanhf(pe[j + 3] + p4.w) * w4.w;
    }
    for (int q = 0; q < S; ++q) cluster.map_shared_rank(s_part, q)[rank * k * T + p] = acc;
  }
  cluster.sync();  // every block has every slice's partial scores

  // α = softmax over T of the slices' partial sums (added in rank order, the
  // same sum in every block), one warp per row, stored transposed
  for (int r = warp; r < k; r += ATT_THREADS / 32) {
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) {
      float e = 0.f;
      for (int q = 0; q < S; ++q) e += s_part[(q * k + r) * T + t];
      s_at[t * kp + r] = e;
      m = fmaxf(m, e);
    }
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(s_at[t * kp + r] - m);
      s_at[t * kp + r] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int t = lane; t < T; t += 32) s_at[t * kp + r] /= s;
  }
  __syncthreads();

  // ctx[:, e0:e0+es] = Σ_t α_t·enc[b]_t: thread (tq, j) takes column j over
  // its share of the steps for RCH rows at a time; shares added in order
  const int ntq = ATT_THREADS / es, tper = (T + ntq - 1) / ntq;
  const int j = tid % es, tq = tid / es;
  const int t0 = tq * tper, t1 = min(T, t0 + tper);
  float* cb = ctx + (size_t)b * k * E + e0;
  for (int r0 = 0; r0 < k; r0 += RCH) {
    const int nr = min(RCH, k - r0);
    if (tq < ntq) {
      float acc[RCH];
#pragma unroll
      for (int r = 0; r < RCH; ++r) acc[r] = 0.f;
      for (int t = t0; t < t1; ++t) {
        const float e = s_en[t * es + j];
        const float4 a0 = *reinterpret_cast<const float4*>(s_at + t * kp + r0);
        const float4 a1 = *reinterpret_cast<const float4*>(s_at + t * kp + r0 + 4);
        acc[0] += a0.x * e;
        acc[1] += a0.y * e;
        acc[2] += a0.z * e;
        acc[3] += a0.w * e;
        acc[4] += a1.x * e;
        acc[5] += a1.y * e;
        acc[6] += a1.z * e;
        acc[7] += a1.w * e;
      }
#pragma unroll
      for (int r = 0; r < RCH; ++r) s_red[(tq * RCH + r) * es + j] = acc[r];
    }
    __syncthreads();
    for (int i = tid; i < nr * es; i += ATT_THREADS) {
      const int r = i / es, jj = i - r * es;
      float s = 0.f;
      for (int q = 0; q < ntq; ++q) s += s_red[(q * RCH + r) * es + jj];
      cb[(size_t)(r0 + r) * E + jj] = s;
    }
    __syncthreads();
  }
}

// ---- tiled products on the tensor cores -------------------------------------
//
// MODE_PROJ: proj_h = h·W_h2h + b_h2h; a block owns rows m0.. and columns
//   n0 = blockIdx.x·BN.., out0 = proj_h (R, H).
// MODE_GATE: z = [h | ctx]·[W_hh; W_ih[:E]] + W_ih[E + tok] + bias and the
//   LSTM update; a block owns rows m0.. and hidden units u0 = blockIdx.x·UNITS..
//   (columns q·H + u0.. of the four gates q), out0 = h', out1 = c'.
// Tile column q·UNITS + c of a block is column n0 + q·UNITS + c (proj) or
// q·H + u0 + c (gate); warp wn owns tile columns q·UNITS + wn·8.. of every q,
// so with MODE_GATE each thread holds all four gates of its (row, unit) pairs.

template <int BM>
constexpr int tile_smem_bytes() {
  return STAGES * (BM * LDA + BK * LDB) * (int)sizeof(float);
}

template <int BM, int MODE>
__global__ void __launch_bounds__(GATE_THREADS) tile_kernel(
    const float* __restrict__ h,     // (R, H)
    const float* __restrict__ ctx,   // (R, E)   gate
    const float* __restrict__ c,     // (R, H)   gate
    const int* __restrict__ tok,     // (R,)     gate
    const float* __restrict__ w_a,   // proj: W_h2h (H, H); gate: W_ih (E + V, 4H)
    const float* __restrict__ w_hh,  // (H, 4H)  gate
    const float* __restrict__ bias,  // proj: b_h2h (H,); gate: bias (4H,)
    float* __restrict__ out0,        // proj: proj_h (R, H); gate: h' (R, H)
    float* __restrict__ out1,        // gate: c' (R, H)
    int R, int H, int E) {
  constexpr int WM = BM / 2;   // rows per warp
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr bool GATE = MODE == MODE_GATE;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                      // STAGES × BM × LDA
  float* sB = smem + STAGES * BM * LDA;  // STAGES × BK × LDB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = warp >> 2;                       // K-group: which half of each stage
  const int wm = (warp >> 1) & 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN, u0 = blockIdx.x * UNITS;
  const int K = GATE ? H + E : H;
  const int ldw = GATE ? 4 * H : H;  // row length of the weights
  const int ktiles = (K + BK - 1) / BK;
  if (!GATE) launch_dependents();

  // tile kt of A = [h | ctx] (proj: h) rows m0.. and of B = [W_hh; W_ih[:E]]
  // (proj: W_h2h); 16-byte chunks, zeros past R and K
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * BK;
    float* a = sA + st * BM * LDA;
    float* bt = sB + st * BK * LDB;
    for (int i = tid; i < BM * (BK / 4); i += GATE_THREADS) {
      const int row = i / (BK / 4), kc = 4 * (i % (BK / 4));
      const int gr = m0 + row, kk = k0 + kc;
      const float* src = h;
      int bytes = 0;
      if (gr < R && kk < K) {
        bytes = 16;
        src = kk < H ? h + (size_t)gr * H + kk : ctx + (size_t)gr * E + (kk - H);
      }
      cp_async16(a + row * LDA + kc, src, bytes);
    }
    for (int i = tid; i < BK * (BN / 4); i += GATE_THREADS) {
      const int kr = i / (BN / 4), cc = i % (BN / 4);
      const int kk = k0 + kr;
      const int col = GATE ? (cc / (UNITS / 4)) * H + u0 + 4 * (cc % (UNITS / 4)) : n0 + 4 * cc;
      const float* src = w_a;
      int bytes = 0;
      if (kk < K) {
        bytes = 16;
        src = (GATE && kk < H) ? w_hh + (size_t)kk * ldw + col
                               : w_a + (size_t)(GATE ? kk - H : kk) * ldw + col;
      }
      cp_async16(bt + kr * LDB + 4 * cc, src, bytes);
    }
  };

  // acc[mi][q][2·hh + j]: row g + 8·hh of m16 tile mi, tile column
  // q·UNITS + wn·8 + 2·tg + j. K-group 0 starts from the bias (and, for the
  // gates, the token row W_ih[E + tok]) and fetches the cell state, so the
  // epilogue waits on no load
  const int col0 = wn * 8 + 2 * tg;
  float acc[MT][4][4];
  float2 cv[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * WM + mi * 16 + g + 8 * hh;
      const bool live = kg == 0 && row < R;
      const float* wt = w_a + ((size_t)E + (GATE && live ? tok[row] : 0)) * ldw + u0 + col0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[mi][q][2 * hh + j] =
              !live ? 0.f
                    : GATE ? wt[q * H + j] + bias[q * H + u0 + col0 + j]
                           : bias[n0 + q * UNITS + col0 + j];
      cv[mi][hh] = GATE && live ? *reinterpret_cast<const float2*>(c + (size_t)row * H + u0 + col0)
                                : make_float2(0.f, 0.f);
    }

  // a cp.async pipeline over tiles [t0, t1), tile t in stage (t - t0) % STAGES
  auto run_tiles = [&](int t0, int t1) {
    for (int s = 0; s < STAGES - 1; ++s) {
      if (t0 + s < t1) load_tile(t0 + s, s);
      cp_async_commit();
    }
    for (int kt = t0; kt < t1; ++kt) {
      cp_async_wait<STAGES - 2>();  // tile kt has landed
      __syncthreads();              // ... for every thread; stage kt-1 is free
      const int nt = kt + STAGES - 1;
      if (nt < t1) load_tile(nt, (nt - t0) % STAGES);
      cp_async_commit();
      const float* sa = sA + ((kt - t0) % STAGES) * BM * LDA;
      const float* sb = sB + ((kt - t0) % STAGES) * BK * LDB;
#pragma unroll
      for (int s8 = 0; s8 < BK / 16; ++s8) {
        const int kk = kg * (BK / 2) + 8 * s8;
        uint32_t ab[MT][4], as[MT][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float* ap = sa + (wm * WM + mi * 16 + g) * LDA + kk + tg;
          split_tf32(ap[0], ab[mi][0], as[mi][0]);            // (g,   tg)
          split_tf32(ap[8 * LDA], ab[mi][1], as[mi][1]);      // (g+8, tg)
          split_tf32(ap[4], ab[mi][2], as[mi][2]);            // (g,   tg+4)
          split_tf32(ap[8 * LDA + 4], ab[mi][3], as[mi][3]);  // (g+8, tg+4)
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* bp = sb + (kk + tg) * LDB + q * UNITS + wn * 8 + g;
          split_tf32(bp[0], bb[q][0], bs[q][0]);        // (k = tg,   n = g)
          split_tf32(bp[4 * LDB], bb[q][1], bs[q][1]);  // (k = tg+4, n = g)
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            mma_tf32(acc[mi][q], as[mi], bb[q]);
            mma_tf32(acc[mi][q], ab[mi], bs[q]);
            mma_tf32(acc[mi][q], ab[mi], bb[q]);
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages are free
  };

  // the gate grid takes the h tiles (while the attention grid still works),
  // then waits for ctx and takes the rest
  const int h_tiles = GATE ? H / BK : ktiles;
  run_tiles(0, h_tiles);
  if (GATE) {
    wait_for_prerequisites();
    run_tiles(h_tiles, ktiles);
  }

  // K-group 1 hands its sums to group 0
  float* red = smem;
  const int gt = tid & 127;
  if (kg == 1) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < 4; ++v) red[((mi * 4 + q) * 4 + v) * 128 + gt] = acc[mi][q][v];
  }
  __syncthreads();
  if (kg == 1) return;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][q][v] += red[((mi * 4 + q) * 4 + v) * 128 + gt];

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * WM + mi * 16 + g + 8 * hh;
      if (row >= R) continue;
      if (!GATE) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float2*>(out0 + (size_t)row * H + n0 + q * UNITS + col0) =
              make_float2(acc[mi][q][2 * hh], acc[mi][q][2 * hh + 1]);
        continue;
      }
      // the LSTM update of (row, unit u0 + col0 + j)
      const size_t o = (size_t)row * H + u0 + col0;
      float hn[2], cn[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int v = 2 * hh + j;  // gates i, f, g, o: acc[mi][0..3][v]
        cn[j] = sigmoidf(acc[mi][1][v]) * (j ? cv[mi][hh].y : cv[mi][hh].x) +
                sigmoidf(acc[mi][0][v]) * tanhf(acc[mi][2][v]);
        hn[j] = sigmoidf(acc[mi][3][v]) * tanhf(cn[j]);
      }
      *reinterpret_cast<float2*>(out1 + o) = make_float2(cn[0], cn[1]);
      *reinterpret_cast<float2*>(out0 + o) = make_float2(hn[0], hn[1]);
    }
}

// ---- host interface -----------------------------------------------------------

// Raise a kernel's dynamic shared memory limit to `bytes` the first time it
// needs more than the default 48 KB (on the current device).
static cudaError_t allow_smem(const void* kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

extern "C" int attention_step_smem_bytes(int k, int T, int H, int E, int S) {
  return (int)sizeof(float) * att_layout(k, T, H, E, S).total;
}

// Launch a tiled product; the gate grid as a programmatic dependent of the
// attention grid. The proj grid follows torch's own kernels, which do not
// trigger their dependents early, so it is launched as usual.
template <int BM, int MODE>
static cudaError_t launch_tiles(dim3 grid, const float* h, const float* ctx, const float* c,
                                const int* tok, const float* w_a, const float* w_hh,
                                const float* bias, float* out0, float* out1, int R, int H,
                                int E, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  cudaError_t err = allow_smem((const void*)tile_kernel<BM, MODE>, tile_smem_bytes<BM>(), &allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GATE_THREADS);
  cfg.dynamicSmemBytes = tile_smem_bytes<BM>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == MODE_GATE ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, tile_kernel<BM, MODE>, h, ctx, c, tok, w_a, w_hh, bias, out0,
                           out1, R, H, E);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One decode step: proj grid, attention grid (B clusters of S blocks), gate
// grid. Needs H % BN == 0, E % (4·S) == 0, H/S and E/S at most ATT_THREADS;
// proj_h (R, H) and ctx (R, E) are scratch. Returns the first launch error, 0
// when all three launched.
extern "C" int attention_step_launch(
    const float* enc, const float* proj_enc, const float* h, const float* c,
    const int* tok, const float* w_h2h, const float* b_h2h, const float* w_score,
    const float* w_ih, const float* w_hh, const float* bias, float* proj_h, float* ctx,
    float* h_out, float* c_out, int B, int k, int T, int H, int E, int S,
    void* stream) {
  const int R = B * k;
  if (R == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  // 32-row tiles while 64 would leave the card under-filled (R ≤ 512)
  const int bm = R <= 512 ? 32 : 64;
  const dim3 pgrid(H / BN, (R + bm - 1) / bm), ggrid(H / UNITS, (R + bm - 1) / bm);
  cudaError_t err =
      bm == 32 ? launch_tiles<32, MODE_PROJ>(pgrid, h, nullptr, nullptr, nullptr, w_h2h, nullptr,
                                             b_h2h, proj_h, nullptr, R, H, E, st)
               : launch_tiles<64, MODE_PROJ>(pgrid, h, nullptr, nullptr, nullptr, w_h2h, nullptr,
                                             b_h2h, proj_h, nullptr, R, H, E, st);
  if (err != cudaSuccess) return (int)err;

  static int att_allowed = 48 * 1024;
  const int smem = attention_step_smem_bytes(k, T, H, E, S);
  err = allow_smem((const void*)attention_kernel, smem, &att_allowed);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, B);
  cfg.blockDim = dim3(ATT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, attention_kernel, enc, proj_enc, (const float*)proj_h, w_score,
                           ctx, k, T, H, E);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = bm == 32 ? launch_tiles<32, MODE_GATE>(ggrid, h, ctx, c, tok, w_ih, w_hh, bias, h_out,
                                               c_out, R, H, E, st)
                 : launch_tiles<64, MODE_GATE>(ggrid, h, ctx, c, tok, w_ih, w_hh, bias, h_out,
                                               c_out, R, H, E, st);
  return (int)err;
}
