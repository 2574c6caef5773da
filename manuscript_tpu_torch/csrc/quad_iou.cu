// Intersection over union of convex quadrilaterals.
//
// Replaces the TPU kernel manuscript_tpu/ops/pallas_iou.py:
// pallas_quad_iou_matrix (body _tile_kernel), and with the pairs and gathered
// entry points the XLA formulation the device NMS calls,
// manuscript_tpu/ops/lanms_jax.py: quad_iou_pairs. Quad a is clipped
// (Sutherland–Hodgman) against the four edges of quad b in an 8-slot vertex
// buffer whose dead slots repeat the last live vertex; the intersection is
// the shoelace area of what is left when more than two vertices remain, and
// IoU = inter / (area_a + area_b - inter), or 0 when that union is not
// positive. The semantics kept from _clip_batch:
// "inside" is side >= 0; a crossing emits the _line_intersection point, which
// is the previous vertex when the lines are parallel (denom == 0); a vertex
// equal to its predecessor (the wrap from slot 7 to slot 0 included) emits
// nothing; emits past 8 are dropped while the count keeps running.
// The lower-triangular prefix-sum matmul and the unrolled masked scatter of the
// Pallas kernel were Mosaic workarounds; a thread here writes its emits in
// order into registers.
//
// What bounds it on an H100: neither bytes nor FLOPs in earnest. A pair reads
// 64 bytes and writes 4, and its clip is ~600 f32 operations, so at the main
// path's 8191 and 16384 pairs both the HBM time (<1 us) and the arithmetic
// time at the f32 peak (<0.2 us) are below a launch's own latency.
//
// What the design does about it: one thread per pair, with the clipped
// polygon in registers (fully unrolled loops over the 8 slots and 4 edges), no
// shared memory and no synchronisation, so the kernel costs one launch and one
// pass over the quads. The gathered entry point, which the NMS calls, reads
// quads[ia[p]] and quads[ib[p]] itself (no gathered copies beforehand) and
// clips only the pairs below a live count that it reads on the device (no
// host sync), writing 0 for the rest; its blocks are one warp each, so 4096
// to 16384 pairs spread over 128 to 512 blocks, one or more on every SM.
// For a chunk of B pages the pairs are B pages of `cap` slots and each page
// has its own live count, so one launch serves the whole chunk.
//
// Compiled with -fmad=false: torch's plain elementwise ops round every
// multiply and add on their own, so keeping nvcc from contracting a*b+c into
// an FMA keeps this kernel within 2e-5 of the plain version on the card.

#include <cuda_runtime.h>
#include <math.h>

#define SLOTS 8

__device__ __forceinline__ float quad_area(const float* q) {
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int n = (v + 1) & 3;
    s += q[2 * v] * q[2 * n + 1] - q[2 * n] * q[2 * v + 1];
  }
  return fabsf(s) / 2.f;
}

__device__ float iou_one(const float* __restrict__ q1, const float* __restrict__ q2) {
  float px[SLOTS], py[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int v = s < 4 ? s : 3;
    px[s] = q1[2 * v];
    py[s] = q1[2 * v + 1];
  }
  int count = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int e1 = (e + 1) & 3;
    const float ax = q2[2 * e], ay = q2[2 * e + 1];
    const float bx = q2[2 * e1], by = q2[2 * e1 + 1];
    const float abx = bx - ax, aby = by - ay;
    float nx[SLOTS], ny[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) nx[s] = ny[s] = 0.f;
    int pos = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int sp = (s + SLOTS - 1) & (SLOTS - 1);
      const float cx = px[s], cy = py[s], qx = px[sp], qy = py[sp];
      const bool cin = abx * (cy - ay) - aby * (cx - ax) >= 0.f;
      const bool pin = abx * (qy - ay) - aby * (qx - ax) >= 0.f;
      if (cx == qx && cy == qy) continue;
      if (cin != pin) {
        const float d1x = cx - qx, d1y = cy - qy;
        const float denom = d1x * aby - d1y * abx;
        const float cax = ax - qx, cay = ay - qy;
        const float t = (cax * aby - cay * abx) / (denom == 0.f ? 1.f : denom);
        float ix = qx + t * d1x, iy = qy + t * d1y;
        if (denom == 0.f) {
          ix = qx;
          iy = qy;
        }
#pragma unroll
        for (int o = 0; o < SLOTS; ++o)
          if (o == pos) {
            nx[o] = ix;
            ny[o] = iy;
          }
        ++pos;
      }
      if (cin) {
#pragma unroll
        for (int o = 0; o < SLOTS; ++o)
          if (o == pos) {
            nx[o] = cx;
            ny[o] = cy;
          }
        ++pos;
      }
    }
    count = pos;
    // repetition-pad: dead slots take the last live vertex (0 when none)
    float lx = 0.f, ly = 0.f;
#pragma unroll
    for (int o = 0; o < SLOTS; ++o)
      if (o == count - 1) {
        lx = nx[o];
        ly = ny[o];
      }
#pragma unroll
    for (int o = 0; o < SLOTS; ++o) {
      const bool live = o < count;
      px[o] = live ? nx[o] : lx;
      py[o] = live ? ny[o] : ly;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int o = 0; o < SLOTS; ++o) {
    const int n = (o + 1) & (SLOTS - 1);
    s += px[o] * py[n] - px[n] * py[o];
  }
  const float inter = count > 2 ? fabsf(s) / 2.f : 0.f;
  const float uni = quad_area(q1) + quad_area(q2) - inter;
  return uni > 0.f ? inter / uni : 0.f;
}

__global__ void quad_iou_pairs_kernel(const float* __restrict__ q1,
                                      const float* __restrict__ q2,
                                      float* __restrict__ out, long long P) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P) out[p] = iou_one(q1 + 8 * p, q2 + 8 * p);
}

__global__ void quad_iou_matrix_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ out, long long N,
                                       long long M) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < N * M) {
    const long long i = p / M, j = p - i * M;
    out[p] = iou_one(a + 8 * i, b + 8 * j);
  }
}

__global__ void quad_iou_gather_kernel(const float* __restrict__ quads,
                                       const int* __restrict__ ia,
                                       const int* __restrict__ ib,
                                       const int* __restrict__ n_live,
                                       float* __restrict__ out, long long P,
                                       long long cap) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long long page = p / cap;
  const bool live = n_live == nullptr || p - page * cap < (long long)n_live[page];
  out[p] = live ? iou_one(quads + 8 * (long long)ia[p], quads + 8 * (long long)ib[p]) : 0.f;
}

extern "C" int quad_iou_pairs_launch(const float* q1, const float* q2, float* out,
                                     long long P, void* stream) {
  if (P > 0) {
    const int threads = 128;
    const long long blocks = (P + threads - 1) / threads;
    quad_iou_pairs_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        q1, q2, out, P);
  }
  return (int)cudaGetLastError();
}

extern "C" int quad_iou_matrix_launch(const float* a, const float* b, float* out,
                                      long long N, long long M, void* stream) {
  if (N * M > 0) {
    const int threads = 128;
    const long long blocks = (N * M + threads - 1) / threads;
    quad_iou_matrix_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        a, b, out, N, M);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3, lanms_merge_scan: the x0-sorted merge chain of the scan LANMS.
//
// A kernel of the port with no Pallas counterpart: it replaces the lax.scan
// merge of manuscript_tpu/ops/lanms_jax.py: locality_aware_nms_jax (XLA).
// Each page's candidate rows [x0..y3, score], already sorted by x0 with the
// padding rows (score < 0) last, are walked in order. A row whose IoU with
// the running quad (the row clipped against it, as quad_iou_pairs(q, cur))
// exceeds the threshold is merged into it: its vertices re-ordered to the
// running quad's (the least squared distance over the 4 cyclic shifts of
// both orientations, forward first), then averaged with weights running
// weight : score, and the running score is the larger of the two. Any other
// row closes the running quad into slot min(m, max_out - 1), m += 1, and
// starts a new one. Padding rows change nothing. The last running quad is
// closed at the end. Outputs: out_p (max_out, 4, 2) zeros past the closed
// quads, out_s (max_out) -inf past them, count m (which may exceed max_out,
// as in the reference; slot max_out - 1 then holds the last closed quad).
//
// What bounds it on an H100: neither bytes nor operations but the chain's
// latency. Every row's decision depends on the running quad, so a page walked
// in order is K dependent steps of one clip and one merge, ~3 us each on one
// thread (24.3 ms at K = 8192), far above what the page's bytes (K·36 in,
// max_out·36 out) or its ~K·860 operations cost.
//
// What the design does about it: the chain is cut where it provably breaks.
// A row that opens a new running quad leaves the state (q_r, s_r, s_r),
// which depends on no earlier row, so two walks of the same rows from
// different entering states agree, bit for bit, from the first row where
// both open a quad. One block per page cuts the page's live extent (up to
// its last live row) into C chunks of L rows, one a thread: by default the
// wrapper launches ceil(K / K3_MIN_CHUNK) threads, K3_THREADS at most, and
// L = max(K3_MIN_CHUNK, ceil(extent / threads)). It runs three passes:
// 1. speculative: each chunk is walked as if it began the page, recording
//    per row whether it merged (0), opened the page's first quad (1), or
//    closed the running quad (2, the closed quad kept beside it), and the
//    chunk's end state;
// 2. fix-up rounds, split by __syncthreads: a chunk whose predecessor's end
//    state changed is stale; it walks again from that state and stops at
//    the first row where this walk and the recorded one both open a quad,
//    since from there the record is exact. A chunk that reaches its end
//    without rejoining has a new end state, and its successor is stale in
//    the next round. The chunks before the first stale one (the front) are
//    exact, so the front's chunk always walks and becomes exact: at most C
//    rounds. Any other stale chunk walks at once too, but only `rewalks`
//    times (the wrapper's default 4): a field of words settles in a few
//    rounds of a few rows, and a page that is one unbroken chain, where
//    every chunk is stale in every round, costs the sequential walk and a
//    few chunks, without hundreds of chunks walking in vain beside the
//    front and taking its issue slots;
// 3. output: a block-wide exclusive scan of the chunks' close counts gives
//    each chunk its first slot, and each chunk writes its closed quads. Past
//    slot max_out - 2 only the page's last quad is written (into the last
//    slot), so no two threads write one slot.
// Every walk runs the same clip (iou_one, as K2) and merge arithmetic,
// compiled with -fmad=false as K2 (each multiply and add rounded on its own,
// as torch's unfused ops round them), so every chunk length gives the outputs
// of L = K, the sequential walk of one thread. A walk loads its next row
// while it clips the current one. The per-row record and the chunks' states
// live in a scratch that the wrapper allocates (L2-resident; a page of 8192
// rows is 295 KB, more than one SM's shared memory). What bounds a page now
// is its longest merged run plus one chunk, walked at the latency of a step
// that is slower than one thread's, since a warp's threads take different
// branches of the clip. Shorter chunks mean more threads and a shorter
// speculative walk, but more rounds where a merged run spans chunks; the
// defaults are the best of examples/torch_port/kernel_bench.py's sweep of
// chunk lengths and re-walks (PERF.md has the times).
#define K3_THREADS 512
#define K3_MIN_CHUNK 8

// Merges the live row (q, s) into the running quad when their IoU exceeds
// thr; false (nothing changed) when the row opens a new quad instead.
__device__ __forceinline__ bool k3_merge(float cur[8], float& cur_s, float& cur_w,
                                         const float q[8], float s, float thr) {
  if (!(iou_one(q, cur) > thr)) return false;
  int best = 0;
  float best_d = 0.f;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = o < 4 ? ((o + i) & 3) : ((o - i) & 3);
      const float dx = q[2 * idx] - cur[2 * i], dy = q[2 * idx + 1] - cur[2 * i + 1];
      d += dx * dx;
      d += dy * dy;
    }
    if (o == 0 || d < best_d) {
      best_d = d;
      best = o;
    }
  }
  float al[8];
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (o == best) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = o < 4 ? ((o + i) & 3) : ((o - i) & 3);
        al[2 * i] = q[2 * idx];
        al[2 * i + 1] = q[2 * idx + 1];
      }
    }
  const float tot = cur_w + s;
  const float den = tot == 0.f ? 1.f : tot;
#pragma unroll
  for (int v = 0; v < 8; ++v) cur[v] = (cur[v] * cur_w + al[v] * s) / den;
  cur_s = fmaxf(cur_s, s);
  cur_w = tot;
  return true;
}

// Walks rows [lo, hi) of a page on from the running quad (cur, cur_s, cur_w;
// none when !has), recording code[r] (0 merged or padding, 1 opened the
// page's first quad, 2 closed the running quad into closed[9r..9r+8] and
// opened a new one). With REJOIN it stops at the first row that opens a quad
// where code[] records an opening too. Returns the live rows walked.
template <bool REJOIN>
__device__ __forceinline__ int k3_walk(const float* __restrict__ rows, long long lo,
                                       long long hi, float thr, float cur[8], float& cur_s,
                                       float& cur_w, bool& has, int* code, float* closed,
                                       bool& rejoined) {
  rejoined = false;
  int walked = 0;
  float nx[9];
  if (lo < hi) {
#pragma unroll
    for (int v = 0; v < 9; ++v) nx[v] = rows[9 * lo + v];
  }
  for (long long r = lo; r < hi; ++r) {
    float q[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) q[v] = nx[v];
    const float s = nx[8];
    if (r + 1 < hi) {  // the next row's load overlaps this row's clip
#pragma unroll
      for (int v = 0; v < 9; ++v) nx[v] = rows[9 * (r + 1) + v];
    }
    if (!(s >= 0.f)) {  // padding
      code[r] = 0;
      continue;
    }
    ++walked;
    if (has && k3_merge(cur, cur_s, cur_w, q, s, thr)) {
      code[r] = 0;
      continue;
    }
    const int old = REJOIN ? code[r] : 0;
    if (has) {
#pragma unroll
      for (int v = 0; v < 8; ++v) closed[9 * r + v] = cur[v];
      closed[9 * r + 8] = cur_s;
    }
    code[r] = has ? 2 : 1;
    if (REJOIN && old != 0) {
      rejoined = true;
      return walked;
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) cur[v] = q[v];
    cur_s = s;
    cur_w = s;
    has = true;
  }
  return walked;
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ long long k3_block_scan(int v, int* warp_sums, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const long long before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

__device__ __forceinline__ void k3_store(float* st, const float cur[8], float cur_s, float cur_w) {
#pragma unroll
  for (int v = 0; v < 8; ++v) st[v] = cur[v];
  st[8] = cur_s;
  st[9] = cur_w;
}

__device__ __forceinline__ void k3_load(const float* st, float cur[8], float& cur_s, float& cur_w) {
#pragma unroll
  for (int v = 0; v < 8; ++v) cur[v] = st[v];
  cur_s = st[8];
  cur_w = st[9];
}

// One block per page. chunk = L > 0 fixes the chunk length, 0 takes
// max(K3_MIN_CHUNK, ceil(extent / blockDim.x)). A chunk re-walks from a
// predecessor that may still change at most `rewalks` times; past that it
// waits until the predecessor is exact. A page's scratch: iscratch K +
// 4·c_cap ints (code; changed, stale, todo, walks a chunk), fscratch 9·K +
// 20·c_cap floats (closed; end and entering states); c_cap >= the chunks of
// the page. stats (5 ints a page: fix-up rounds, re-walks, rows re-walked,
// most rows of one re-walk, the chunk length) or NULL.
__global__ void __launch_bounds__(K3_THREADS)
lanms_merge_scan_kernel(const float* __restrict__ rows, long long K, float thr,
                        long long max_out, long long chunk, int rewalks, long long c_cap,
                        float* __restrict__ out_p, float* __restrict__ out_s,
                        int* __restrict__ count, int* __restrict__ iscratch,
                        float* __restrict__ fscratch, int* __restrict__ stats) {
  const long long page = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  rows += page * K * 9;
  out_p += page * max_out * 8;
  out_s += page * max_out;
  int* code = iscratch + page * (K + 4 * c_cap);
  int* changed = code + K;  // the chunk's end state changed in the last pass
  int* stale = changed + c_cap;  // walked from another state than its predecessor's end
  int* todo = stale + c_cap;
  int* walks = todo + c_cap;
  float* closed = fscratch + page * (9 * K + 20 * c_cap);
  float* end = closed + 9 * K;
  float* enter = end + 10 * c_cap;
  if (stats != nullptr) stats += 5 * page;

  __shared__ int warp_sums[32];
  __shared__ int last_live, front;
  if (tid == 0) {
    last_live = -1;
    if (stats != nullptr) stats[0] = stats[1] = stats[2] = stats[3] = stats[4] = 0;
  }
  __syncthreads();
  int last = -1;
  for (long long r = tid; r < K; r += T)
    if (rows[9 * r + 8] >= 0.f) last = (int)r;
  if (last >= 0) atomicMax(&last_live, last);
  __syncthreads();
  const long long n = last_live + 1;  // the live extent
  const long long even = (n + T - 1) / T;
  const long long L = chunk > 0 ? chunk : (even > K3_MIN_CHUNK ? even : K3_MIN_CHUNK);
  const long long C = (n + L - 1) / L;
  if (stats != nullptr && tid == 0) stats[4] = (int)L;

  // 1. speculative walks, each chunk from no running quad
  for (long long c = tid; c < C; c += T) {
    float cur[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, cur_s = 0.f, cur_w = 0.f;
    bool has = false, rejoined;
    const long long lo = c * L, hi = lo + L < n ? lo + L : n;
    k3_walk<false>(rows, lo, hi, thr, cur, cur_s, cur_w, has, code, closed, rejoined);
    k3_store(end + 10 * c, cur, cur_s, cur_w);
    changed[c] = has;  // the successor walked from no quad
    stale[c] = walks[c] = 0;
  }
  if (tid == 0) front = (int)C;
  __syncthreads();

  // 2. fix-up rounds. Chunks before the first stale one (the front) are
  // exact, so the front's chunk always walks; the others walk while they
  // have re-walks left
  for (int round = 1;; ++round) {
    for (long long c = tid; c < C; c += T) {
      if (c > 0 && changed[c - 1]) stale[c] = 1;
      if (stale[c]) atomicMin(&front, (int)c);
    }
    __syncthreads();
    const long long f = front;
    for (long long c = tid; c < C; c += T) {
      const int t = stale[c] && (c == f || walks[c] < rewalks);
      todo[c] = t;
      if (t) {
#pragma unroll
        for (int v = 0; v < 10; ++v) enter[10 * c + v] = end[10 * (c - 1) + v];
      }
    }
    __syncthreads();
    if (tid == 0) front = (int)C;
    int more = 0;
    for (long long c = tid; c < C; c += T) {
      changed[c] = 0;
      if (todo[c]) {
        float cur[8], cur_s, cur_w;
        k3_load(enter + 10 * c, cur, cur_s, cur_w);
        bool has = true, rejoined;
        const long long lo = c * L, hi = lo + L < n ? lo + L : n;
        const int walked =
            k3_walk<true>(rows, lo, hi, thr, cur, cur_s, cur_w, has, code, closed, rejoined);
        stale[c] = 0;
        ++walks[c];
        if (!rejoined) {
          k3_store(end + 10 * c, cur, cur_s, cur_w);
          changed[c] = c + 1 < C;
        }
        if (stats != nullptr) {
          atomicMax(stats + 0, round);
          atomicAdd(stats + 1, 1);
          atomicAdd(stats + 2, walked);
          atomicMax(stats + 3, walked);
        }
      }
      more |= stale[c] | changed[c];
    }
    if (!__syncthreads_or(more)) break;
  }

  // 3. output: each chunk's first slot from a scan of the close counts
  long long closes = 0;
  for (long long base = 0; base < C; base += T) {
    const long long c = base + tid;
    const long long lo = c * L, hi = c < C ? (lo + L < n ? lo + L : n) : lo;
    int cnt = 0;
    for (long long r = lo; r < hi; ++r) cnt += code[r] == 2;
    long long total;
    long long j = closes + k3_block_scan(cnt, warp_sums, &total);
    for (long long r = lo; r < hi; ++r) {
      if (code[r] != 2) continue;
      if (j < max_out - 1) {  // the last slot takes the page's last quad only
#pragma unroll
        for (int v = 0; v < 8; ++v) out_p[8 * j + v] = closed[9 * r + v];
        out_s[j] = closed[9 * r + 8];
      }
      ++j;
    }
    closes += total;
  }
  const long long m = closes + (C > 0);
  if (tid == 0) {
    if (C > 0) {  // the last running quad, the end state of the last chunk
      const long long slot = m - 1 < max_out - 1 ? m - 1 : max_out - 1;
#pragma unroll
      for (int v = 0; v < 8; ++v) out_p[8 * slot + v] = end[10 * (C - 1) + v];
      out_s[slot] = end[10 * (C - 1) + 8];
    }
    count[page] = (int)m;
  }
  const long long filled = m < max_out ? m : max_out;
  for (long long i = filled * 8 + tid; i < max_out * 8; i += T) out_p[i] = 0.f;
  for (long long i = filled + tid; i < max_out; i += T) out_s[i] = -INFINITY;
}

// rows: B pages of K x0-sorted rows of 9 floats; out_p (B, max_out, 8),
// out_s (B, max_out), count (B) int; max_out >= 1; threads a multiple of 32
// up to K3_THREADS; chunk 0 or the chunk length; rewalks >= 0; scratch and
// stats as the kernel above says.
extern "C" int lanms_merge_scan_launch(const float* rows, long long B, long long K, float thr,
                                       long long max_out, long long chunk, int rewalks,
                                       int threads, long long c_cap, float* out_p, float* out_s,
                                       int* count, int* iscratch, float* fscratch, int* stats,
                                       void* stream) {
  if (threads <= 0 || threads > K3_THREADS || threads % 32 != 0 || chunk < 0 || rewalks < 0 ||
      c_cap < (chunk > 0 ? (K + chunk - 1) / chunk : threads))
    return (int)cudaErrorInvalidValue;
  if (B > 0)
    lanms_merge_scan_kernel<<<(unsigned)B, threads, 0, (cudaStream_t)stream>>>(
        rows, K, thr, max_out, chunk, rewalks, c_cap, out_p, out_s, count, iscratch, fscratch,
        stats);
  return (int)cudaGetLastError();
}

// The P pairs are pages of `cap` slots (cap divides P; one page when cap = P).
// n_live: device ints, one per page (slot p is clipped when p mod cap <
// n_live[p / cap], the rest give 0), or NULL for all P pairs.
extern "C" int quad_iou_gather_launch(const float* quads, const int* ia, const int* ib,
                                      const int* n_live, float* out, long long P,
                                      long long cap, void* stream) {
  if (P > 0 && cap > 0) {
    const int threads = 32;
    const long long blocks = (P + threads - 1) / threads;
    quad_iou_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        quads, ia, ib, n_live, out, P, cap);
  }
  return (int)cudaGetLastError();
}
