// Locality-aware NMS on the host, in C++ (the port's own copy of the JAX
// package's native/lanms.cpp; the two must give the same bits).
//
// The detector's candidates (score-bearing quads) are stable-sorted by x0,
// merged one after another into the running score-weighted average quad
// while their IoU with it clears the threshold (vertex order normalised
// first), and the merged quads then go through a greedy score-descending
// NMS. A disjoint bounding-box pair skips the polygon clip: its IoU is 0.
//
// Exported C ABI:
//   int64_t lanms(const double* boxes, int64_t n, double iou_threshold,
//                 double* out);
//     boxes: n rows of [x0,y0,x1,y1,x2,y2,x3,y3,score]
//     out:   caller-allocated n*9 doubles; returns the number of kept rows.
//
// Built at first use by manuscript_tpu_torch/ops/_build.py with the host C++
// compiler: -O3 -std=c++17 -fPIC -shared and no -march=native, so that on
// x86-64 no multiply-add is contracted into an FMA and the bits equal those
// of the JAX package's library, built by native/Makefile with the same flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

struct BBox {
  double x0, y0, x1, y1;
};

constexpr int kClipBuf = 20;

BBox quad_bbox(const Pt* q) {
  BBox b{q[0].x, q[0].y, q[0].x, q[0].y};
  for (int i = 1; i < 4; ++i) {
    b.x0 = std::min(b.x0, q[i].x);
    b.y0 = std::min(b.y0, q[i].y);
    b.x1 = std::max(b.x1, q[i].x);
    b.y1 = std::max(b.y1, q[i].y);
  }
  return b;
}

// Spatial prior (ASAP-NMS-style): disjoint bboxes ⇒ IoU is exactly 0,
// skip the polygon clipping entirely.
inline bool bbox_overlap(const BBox& a, const BBox& b) {
  return !(a.x1 < b.x0 || b.x1 < a.x0 || a.y1 < b.y0 || b.y1 < a.y0);
}

double polygon_area(const Pt* p, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return std::fabs(a) / 2.0;
}

Pt line_intersection(Pt p1, Pt p2, Pt a, Pt b) {
  const double dx1 = p2.x - p1.x, dy1 = p2.y - p1.y;
  const double dx2 = b.x - a.x, dy2 = b.y - a.y;
  const double denom = dx1 * dy2 - dy1 * dx2;
  if (denom == 0.0) return p1;
  const double cax = a.x - p1.x, cay = a.y - p1.y;
  const double t = (cax * dy2 - cay * dx2) / denom;
  return Pt{p1.x + t * dx1, p1.y + t * dy1};
}

// Clip subject polygon against half-plane left of directed line a->b.
int clip_polygon(const Pt* subject, int n, Pt a, Pt b, Pt* out) {
  int count = 0;
  const double abx = b.x - a.x, aby = b.y - a.y;
  for (int i = 0; i < n; ++i) {
    const Pt curr = subject[i];
    const Pt prev = subject[(i - 1 + n) % n];
    const bool curr_in = abx * (curr.y - a.y) - aby * (curr.x - a.x) >= 0.0;
    const bool prev_in = abx * (prev.y - a.y) - aby * (prev.x - a.x) >= 0.0;
    if (curr_in) {
      if (!prev_in) out[count++] = line_intersection(prev, curr, a, b);
      out[count++] = curr;
    } else if (prev_in) {
      out[count++] = line_intersection(prev, curr, a, b);
    }
  }
  return count;
}

double quad_iou(const Pt* q1, const Pt* q2) {
  Pt bufA[kClipBuf], bufB[kClipBuf];
  Pt* cur = bufA;
  Pt* nxt = bufB;
  int n = 4;
  for (int i = 0; i < 4; ++i) cur[i] = q1[i];
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_polygon(cur, n, q2[e], q2[(e + 1) % 4], nxt);
    std::swap(cur, nxt);
  }
  double inter = (n > 2) ? polygon_area(cur, n) : 0.0;
  const double a1 = polygon_area(q1, 4);
  const double a2 = polygon_area(q2, 4);
  const double uni = a1 + a2 - inter;
  return (uni <= 0.0) ? 0.0 : inter / uni;
}

// Reorder poly's vertices (all cyclic shifts, both orientations) to minimize
// total squared distance to ref's vertex order; forward orientation wins ties.
void normalize_quad(const Pt* ref, const Pt* poly, Pt* out) {
  int best_start = 0, best_dir = 0;
  double min_d = 1e300;
  for (int dir = 0; dir < 2; ++dir) {
    for (int start = 0; start < 4; ++start) {
      double d = 0.0;
      for (int i = 0; i < 4; ++i) {
        const int idx = dir == 0 ? (start + i) % 4 : ((start - i) % 4 + 4) % 4;
        const double dx = ref[i].x - poly[idx].x;
        const double dy = ref[i].y - poly[idx].y;
        d += dx * dx + dy * dy;
      }
      if (d < min_d) {
        min_d = d;
        best_start = start;
        best_dir = dir;
      }
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int idx = best_dir == 0 ? (best_start + i) % 4
                                  : ((best_start - i) % 4 + 4) % 4;
    out[i] = poly[idx];
  }
}

}  // namespace

extern "C" int64_t lanms(const double* boxes, int64_t n, double iou_threshold,
                         double* out) {
  if (n <= 0) return 0;

  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return boxes[a * 9] < boxes[b * 9];
  });

  // Sequential locality-aware merge over x0-sorted boxes.
  std::vector<Pt> merged;          // 4 points per merged quad
  std::vector<double> scores;      // max score per merged quad
  std::vector<double> weights;     // accumulated score weight per quad
  merged.reserve(4 * n);

  for (int64_t k = 0; k < n; ++k) {
    const double* row = boxes + order[k] * 9;
    Pt q[4];
    for (int i = 0; i < 4; ++i) q[i] = Pt{row[2 * i], row[2 * i + 1]};
    const double s = row[8];

    if (!merged.empty()) {
      Pt* last = merged.data() + merged.size() - 4;
      if (bbox_overlap(quad_bbox(q), quad_bbox(last)) &&
          quad_iou(q, last) > iou_threshold) {
        Pt aligned[4];
        normalize_quad(last, q, aligned);
        const double w = weights.back();
        const double total = w + s;
        for (int i = 0; i < 4; ++i) {
          last[i].x = (last[i].x * w + aligned[i].x * s) / total;
          last[i].y = (last[i].y * w + aligned[i].y * s) / total;
        }
        weights.back() = total;
        scores.back() = std::max(scores.back(), s);
        continue;
      }
    }
    for (int i = 0; i < 4; ++i) merged.push_back(q[i]);
    scores.push_back(s);
    weights.push_back(s);
  }

  // Standard greedy NMS over the merged quads, score-descending.
  const int64_t m = static_cast<int64_t>(scores.size());
  std::vector<int64_t> sorder(m);
  std::iota(sorder.begin(), sorder.end(), 0);
  std::stable_sort(sorder.begin(), sorder.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });

  std::vector<BBox> boxes_bb(m);
  for (int64_t i = 0; i < m; ++i) boxes_bb[i] = quad_bbox(merged.data() + i * 4);

  std::vector<char> suppressed(m, 0);
  int64_t kept = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t idx = sorder[i];
    if (suppressed[idx]) continue;
    const Pt* qi = merged.data() + idx * 4;
    double* dst = out + kept * 9;
    for (int v = 0; v < 4; ++v) {
      dst[2 * v] = qi[v].x;
      dst[2 * v + 1] = qi[v].y;
    }
    dst[8] = scores[idx];
    ++kept;
    for (int64_t j = i + 1; j < m; ++j) {
      const int64_t jdx = sorder[j];
      if (suppressed[jdx]) continue;
      if (!bbox_overlap(boxes_bb[idx], boxes_bb[jdx])) continue;
      if (quad_iou(qi, merged.data() + jdx * 4) > iou_threshold)
        suppressed[jdx] = 1;
    }
  }
  return kept;
}
