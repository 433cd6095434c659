// Host z-buffer rasterizer for the overlay renderer (render/render.py).
//
// The rasterizer of native/multihmr_native.cpp (mh_rasterize) alone: it needs
// only the standard library, so it builds wherever a C++17 compiler is, with
// no image codecs. Built at first use by io/native.py:
//
//   g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off
//
// -ffp-contract=off keeps every product and sum rounded on its own, as numpy
// rounds them in render.py::_rasterize, its plain version.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <vector>

extern "C" {

// Z-buffer triangle rasterizer with flat Lambertian shading.
// verts: [V,3] camera-space float32; faces: [F,3] int32; K: [9] row-major.
// rgb (in/out): [H,W,3] float32 shade*color written at covered pixels;
// depth (in/out): [H,W] float32 (caller initializes to +inf), shared across
// calls so that meshes drawn one after another occlude each other.
void mh_rasterize(const float* verts, int n_verts, const int32_t* faces,
                  int n_faces, const float* K, int width, int height,
                  float cr, float cg, float cb, float* rgb, float* depth) {
  std::vector<float> vx(n_verts), vy(n_verts), vz(n_verts);
  for (int i = 0; i < n_verts; ++i) {
    float X = verts[3 * i], Y = verts[3 * i + 1], Z = verts[3 * i + 2];
    float z = Z > 1e-9f ? Z : 1e-9f;
    vx[i] = (K[0] * X + K[1] * Y + K[2] * Z) / z;
    vy[i] = (K[3] * X + K[4] * Y + K[5] * Z) / z;
    vz[i] = Z;
  }
  for (int f = 0; f < n_faces; ++f) {
    int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= n_verts || i1 >= n_verts || i2 >= n_verts)
      continue;
    if (vz[i0] <= 1e-6f || vz[i1] <= 1e-6f || vz[i2] <= 1e-6f) continue;
    float ax = vx[i0], ay = vy[i0], bx = vx[i1], by = vy[i1], cx = vx[i2], cy = vy[i2];
    float det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay);
    if (std::abs(det) < 1e-12f) continue;
    int x0 = std::max(0, (int)std::floor(std::min({ax, bx, cx})));
    int x1 = std::min(width - 1, (int)std::ceil(std::max({ax, bx, cx})));
    int y0 = std::max(0, (int)std::floor(std::min({ay, by, cy})));
    int y1 = std::min(height - 1, (int)std::ceil(std::max({ay, by, cy})));
    if (x1 < x0 || y1 < y0) continue;
    // camera-space normal for shading (double-sided)
    float e1x = verts[3 * i1] - verts[3 * i0], e1y = verts[3 * i1 + 1] - verts[3 * i0 + 1],
          e1z = verts[3 * i1 + 2] - verts[3 * i0 + 2];
    float e2x = verts[3 * i2] - verts[3 * i0], e2y = verts[3 * i2 + 1] - verts[3 * i0 + 1],
          e2z = verts[3 * i2 + 2] - verts[3 * i0 + 2];
    float nx = e1y * e2z - e1z * e2y, ny = e1z * e2x - e1x * e2z, nz = e1x * e2y - e1y * e2x;
    float nn = std::sqrt(nx * nx + ny * ny + nz * nz);
    float shade = 0.35f + 0.65f * (nn > 1e-12f ? std::abs(nz) / nn : 1.0f);
    float inv_det = 1.0f / det;
    for (int y = y0; y <= y1; ++y) {
      float py = y + 0.5f;
      for (int x = x0; x <= x1; ++x) {
        float px = x + 0.5f;
        float l1 = ((px - ax) * (cy - ay) - (cx - ax) * (py - ay)) * inv_det;
        float l2 = ((bx - ax) * (py - ay) - (px - ax) * (by - ay)) * inv_det;
        float l0 = 1.0f - l1 - l2;
        if (l0 < 0 || l1 < 0 || l2 < 0) continue;
        float z = l0 * vz[i0] + l1 * vz[i1] + l2 * vz[i2];
        float* d = depth + (size_t)y * width + x;
        if (z < *d) {
          *d = z;
          float* p = rgb + ((size_t)y * width + x) * 3;
          p[0] = shade * cr;
          p[1] = shade * cg;
          p[2] = shade * cb;
        }
      }
    }
  }
}

}  // extern "C"
