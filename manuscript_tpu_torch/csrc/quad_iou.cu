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
                                       float* __restrict__ out, long long P) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long long live = n_live ? (long long)*n_live : P;
  out[p] = p < live ? iou_one(quads + 8 * (long long)ia[p], quads + 8 * (long long)ib[p])
                    : 0.f;
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

// n_live: a device int (pairs p < *n_live are clipped, the rest give 0), or
// NULL for all P pairs.
extern "C" int quad_iou_gather_launch(const float* quads, const int* ia, const int* ib,
                                      const int* n_live, float* out, long long P,
                                      void* stream) {
  if (P > 0) {
    const int threads = 32;
    const long long blocks = (P + threads - 1) / threads;
    quad_iou_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        quads, ia, ib, n_live, out, P);
  }
  return (int)cudaGetLastError();
}
