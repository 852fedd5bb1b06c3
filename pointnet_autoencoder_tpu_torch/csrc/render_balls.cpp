// Z-buffer ball-splat point-cloud renderer (host C++, no CUDA): the port's
// copy of pointnet_autoencoder_tpu/csrc/render_balls.cpp.
//
// Rasterizes n projected points as shaded spheres into an RGB image with
// depth occlusion, the role of the reference's ctypes renderer
// (utils/render_balls_so.cpp): float pixel coordinates, one sphere
// shading disc shared by every point, contiguous RGB float colors.
//
// C ABI for ctypes (viz/render.py); built with g++ by csrc/build.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// img:    h*w*3 uint8, already filled with the background.
// xyz:    n*3 float — x (col), y (row) in pixels, z depth (larger = nearer).
// rgb:    n*3 float in [0,255].
// radius: splat radius in pixels (>=1).
void render_spheres(int h, int w, uint8_t* img, int n, const float* xyz,
                    const float* rgb, int radius) {
  radius = std::max(radius, 1);
  std::vector<float> zbuf(static_cast<size_t>(h) * w,
                          -std::numeric_limits<float>::infinity());

  // Precompute the sphere disc: offsets and unit depth (shading) per pixel.
  struct Texel {
    int dx, dy;
    float dz;     // sphere surface height above the disc plane
    float shade;  // Lambertian-ish falloff toward the silhouette
  };
  std::vector<Texel> disc;
  disc.reserve(static_cast<size_t>(4 * radius * radius));
  const float r2 = static_cast<float>(radius) * radius;
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx) {
      float d2 = static_cast<float>(dx * dx + dy * dy);
      if (d2 < r2) {
        float dz = std::sqrt(r2 - d2);
        disc.push_back({dx, dy, dz, dz / radius});
      }
    }
  }

  // Depth range for global intensity modulation.
  float zmin = std::numeric_limits<float>::infinity();
  float zmax = -zmin;
  for (int i = 0; i < n; ++i) {
    zmin = std::min(zmin, xyz[i * 3 + 2]);
    zmax = std::max(zmax, xyz[i * 3 + 2]);
  }
  const float zspan = std::max(zmax - zmin, 1e-6f);

  for (int i = 0; i < n; ++i) {
    const float fx = xyz[i * 3 + 0];
    const float fy = xyz[i * 3 + 1];
    // Early-out for off-screen (or NaN/overflowing) centers: keeps the
    // cx + dx arithmetic below safely in int range and skips the whole
    // disc for points that cannot touch the image.
    if (!(fx >= -radius && fx <= w + radius &&
          fy >= -radius && fy <= h + radius)) {
      continue;
    }
    const int cx = static_cast<int>(std::lround(fx));
    const int cy = static_cast<int>(std::lround(fy));
    const float cz = xyz[i * 3 + 2];
    // Farther points render dimmer (0.3 .. 1.0).
    const float depth_gain = 0.3f + 0.7f * ((cz - zmin) / zspan);
    const float cr = rgb[i * 3 + 0];
    const float cg = rgb[i * 3 + 1];
    const float cb = rgb[i * 3 + 2];
    for (const Texel& t : disc) {
      const int x = cx + t.dx;
      const int y = cy + t.dy;
      if (x < 0 || x >= w || y < 0 || y >= h) continue;
      const size_t pix = static_cast<size_t>(y) * w + x;
      const float z = cz + t.dz;
      if (zbuf[pix] >= z) continue;
      zbuf[pix] = z;
      const float gain = depth_gain * t.shade;
      img[pix * 3 + 0] = static_cast<uint8_t>(std::min(255.f, cr * gain));
      img[pix * 3 + 1] = static_cast<uint8_t>(std::min(255.f, cg * gain));
      img[pix * 3 + 2] = static_cast<uint8_t>(std::min(255.f, cb * gain));
    }
  }
}

}  // extern "C"
