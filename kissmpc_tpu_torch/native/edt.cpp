// Native fast path for the occupancy-map tooling: exact Euclidean distance
// transform (Felzenszwalb-Huttenlocher) and greedy maximal-inscribed-circle
// packing.  Replaces the OpenCV dependency of the reference's map script
// (obstacle_handling/static_obstacle.py:34-56) with a self-contained C ABI
// used from Python via ctypes (kissmpc_tpu_torch/native/__init__.py); the
// numpy implementation in kissmpc_tpu_torch/obstacles/mapping.py is the
// oracle.  A copy of kissmpc_tpu/native/edt.cpp, owned by the port.
//
// Build: compiled into libkissmpc_native-<hash>.so together with
// mailbox.cpp, under build/kissmpc_tpu_torch/native/ (the loader).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// 1-D squared distance transform: lower envelope of parabolas rooted at
// (i, f[i]).  f entries must be finite (large sentinel for "no source").
void edt_1d_sq(const double* f, double* d, int n, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -std::numeric_limits<double>::infinity();
  z[1] = std::numeric_limits<double>::infinity();
  for (int q = 1; q < n; ++q) {
    double s;
    for (;;) {
      int p = v[k];
      s = ((f[q] + double(q) * q) - (f[p] + double(p) * p)) /
          (2.0 * q - 2.0 * p);
      if (k > 0 && s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = std::numeric_limits<double>::infinity();
  }
  int j = 0;
  for (int q = 0; q < n; ++q) {
    while (z[j + 1] < q) ++j;
    int p = v[j];
    d[q] = (double(q) - p) * (double(q) - p) + f[p];
  }
}

}  // namespace

extern "C" {

// Exact EDT of a binary image: out[y*w+x] = distance from each nonzero
// (foreground) pixel to the nearest zero pixel.  Matches
// cv2.distanceTransform(img, DIST_L2, DIST_MASK_PRECISE).
void kissmpc_edt(const uint8_t* fg, int h, int w, float* out) {
  const double big = double(h) * h + double(w) * w + 1.0;
  std::vector<double> d(size_t(h) * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      d[size_t(y) * w + x] = fg[size_t(y) * w + x] ? big : 0.0;

  // pass 1: columns
  std::vector<double> col(h), colo(h), zbuf(std::max(h, w) + 1);
  std::vector<int> vbuf(std::max(h, w));
  for (int x = 0; x < w; ++x) {
    bool any = false;
    for (int y = 0; y < h; ++y) {
      col[y] = d[size_t(y) * w + x];
      if (col[y] != 0.0) any = true;
    }
    if (!any) continue;
    edt_1d_sq(col.data(), colo.data(), h, vbuf.data(), zbuf.data());
    for (int y = 0; y < h; ++y)
      d[size_t(y) * w + x] = std::min(colo[y], big);
  }
  // pass 2: rows
  std::vector<double> rowo(w);
  for (int y = 0; y < h; ++y) {
    edt_1d_sq(&d[size_t(y) * w], rowo.data(), w, vbuf.data(), zbuf.data());
    for (int x = 0; x < w; ++x)
      out[size_t(y) * w + x] = float(std::sqrt(std::min(rowo[x], big)));
  }
}

// Greedy circle packing on a (mutable) distance transform, reference loop
// semantics (static_obstacle.py:37-56): repeatedly take the global max as a
// circle, zero its disk in the transform, until max < min_radius or
// max_circles found.  Returns the number of circles written.
int kissmpc_pack_circles(float* dist, int h, int w, float min_radius,
                         int max_circles, float* centers_xy, float* radii) {
  int count = 0;
  while (count < max_circles) {
    // global max scan
    float best = -1.0f;
    int by = 0, bx = 0;
    const size_t n = size_t(h) * w;
    for (size_t i = 0; i < n; ++i) {
      if (dist[i] > best) {
        best = dist[i];
        by = int(i / w);
        bx = int(i % w);
      }
    }
    if (best < min_radius) break;
    centers_xy[2 * count] = float(bx);
    centers_xy[2 * count + 1] = float(by);
    radii[count] = best;
    ++count;
    const int ri = int(best);
    const int y0 = std::max(0, by - ri), y1 = std::min(h, by + ri + 1);
    const int x0 = std::max(0, bx - ri), x1 = std::min(w, bx + ri + 1);
    const int r2 = ri * ri;
    for (int y = y0; y < y1; ++y) {
      const int dy = y - by;
      for (int x = x0; x < x1; ++x) {
        const int dx = x - bx;
        if (dy * dy + dx * dx <= r2) dist[size_t(y) * w + x] = 0.0f;
      }
    }
  }
  return count;
}

}  // extern "C"
