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
// as in the reference).
//
// What bounds it on an H100: neither bytes nor operations. Every step
// depends on the one before (the IoU is taken against the running quad), so
// a page is one chain of K dependent clips: the time is K times the latency
// of one step's arithmetic on one thread, far above what the page's bytes
// (K·36 in, max_out·36 out) or its ~K·700 operations cost.
//
// What the design does about it: one block per page, whose threads fill the
// outputs' padding in parallel, then one thread walks the chain with the
// running quad, the row and the clip buffer in registers (iou_one above, the
// same clip as K2, and -fmad=false as there, so a merge rounds as torch's
// unfused ops do). Padding rows are skipped with one compare. A simple and
// correct kernel first: splitting the chain where it provably breaks is the
// way to make it faster.
__global__ void lanms_merge_scan_kernel(const float* __restrict__ rows, long long K, float thr,
                                        long long max_out, float* __restrict__ out_p,
                                        float* __restrict__ out_s, int* __restrict__ count) {
  const long long page = blockIdx.x;
  rows += page * K * 9;
  out_p += page * max_out * 8;
  out_s += page * max_out;
  for (long long i = threadIdx.x; i < max_out * 8; i += blockDim.x) out_p[i] = 0.f;
  for (long long i = threadIdx.x; i < max_out; i += blockDim.x) out_s[i] = -INFINITY;
  __syncthreads();
  if (threadIdx.x != 0) return;

  float cur[8], cur_s = 0.f, cur_w = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) cur[v] = 0.f;
  bool has_cur = false;
  long long m = 0;
  for (long long k = 0; k < K; ++k) {
    const float* r = rows + 9 * k;
    const float s = r[8];
    if (!(s >= 0.f)) continue;  // padding
    float q[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) q[v] = r[v];
    if (has_cur) {
      if (iou_one(q, cur) > thr) {
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
        continue;
      }
      const long long slot = m < max_out - 1 ? m : max_out - 1;
#pragma unroll
      for (int v = 0; v < 8; ++v) out_p[8 * slot + v] = cur[v];
      out_s[slot] = cur_s;
      ++m;
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) cur[v] = q[v];
    cur_s = s;
    cur_w = s;
    has_cur = true;
  }
  if (has_cur) {
    const long long slot = m < max_out - 1 ? m : max_out - 1;
#pragma unroll
    for (int v = 0; v < 8; ++v) out_p[8 * slot + v] = cur[v];
    out_s[slot] = cur_s;
    ++m;
  }
  count[page] = (int)m;
}

// rows: B pages of K x0-sorted rows of 9 floats; out_p (B, max_out, 8),
// out_s (B, max_out), count (B) int; max_out >= 1.
extern "C" int lanms_merge_scan_launch(const float* rows, long long B, long long K, float thr,
                                       long long max_out, float* out_p, float* out_s, int* count,
                                       void* stream) {
  if (B > 0)
    lanms_merge_scan_kernel<<<(unsigned)B, 128, 0, (cudaStream_t)stream>>>(rows, K, thr, max_out,
                                                                           out_p, out_s, count);
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
