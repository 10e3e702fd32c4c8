// Native host-side scan packer.
//
// The reference does its host-side preprocessing in C++ inside ROS callbacks
// (reference src/sensors/lidar/frame.cpp:101-193: range gate, per-point
// relative time with constant-rotation fallback, sort by time). This is the
// framework's equivalent host runtime component: it turns a raw sensor
// buffer into the padded, time-sorted, masked tensors the jitted device step
// consumes — off the Python interpreter, overlapping with device compute in
// the runner's prefetch thread.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -shared -fPIC scan_packer.cpp -o libscanpack.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct PackParams {
  double min_range;
  double max_range;
  double stamp;          // message header time (s)
  double frame_rate;     // Hz, for the rotation-model fallback
  double angle_limit;    // degrees (max_angle - min_angle)
  int32_t num_scan_lines;
  int32_t max_points;    // output capacity
};

}  // namespace

extern "C" {

// Returns the number of valid output points (<= max_points).
//
// Inputs (length n):
//   xyz   : float32 x n*3
//   times : float64 x n absolute per-point stamps; pass nullptr or all<=0
//           to trigger the rotation-model fallback
//   ring  : int32 x n scan-line index (used only by the fallback); nullptr ok
// Outputs (length params.max_points, caller-allocated):
//   out_xyz  : float32 x max_points*3, time-sorted, zero padding
//   out_tau  : float32 x max_points, normalized [0,1] in-scan time
//   out_rel  : float64 x max_points, seconds since scan start
//   out_mask : uint8 x max_points
// Out scalars: t_begin, t_end (float64[1] each).
int pack_scan(const float* xyz, const double* times, const int32_t* ring,
              int32_t n, const PackParams* p, float* out_xyz, float* out_tau,
              double* out_rel, uint8_t* out_mask, double* t_begin,
              double* t_end) {
  const double blind_sq = p->min_range * p->min_range;
  const double max_sq = p->max_range * p->max_range;

  // 1. range gate + NaN drop (reference frame.cpp:143-145)
  std::vector<int32_t> keep;
  keep.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (std::isnan(x) || std::isnan(y) || std::isnan(z)) continue;
    const double d = double(x) * x + double(y) * y + double(z) * z;
    if (d < blind_sq || d > max_sq) continue;
    keep.push_back(i);
  }

  // 2. per-point relative time
  bool has_time = false;
  if (times != nullptr) {
    for (int32_t i : keep) {
      if (times[i] > 0) { has_time = true; break; }
    }
  }
  std::vector<double> rel(keep.size());
  if (has_time) {
    for (size_t k = 0; k < keep.size(); ++k) rel[k] = times[keep[k]] - p->stamp;
  } else {
    // constant-rotation fallback (reference frame.cpp:159-182): first valid
    // point of each ring anchors the azimuth; offset time =
    // ((yaw_fp - yaw) mod angle_limit) / (deg per ms), converted to seconds
    const double ang_vel = p->frame_rate * 360.0 / 1000.0;  // deg/ms
    std::vector<double> yaw_fp(p->num_scan_lines,
                               std::numeric_limits<double>::quiet_NaN());
    for (size_t k = 0; k < keep.size(); ++k) {
      const int32_t i = keep[k];
      const double yaw =
          std::atan2(xyz[3 * i + 1], xyz[3 * i]) * (180.0 / kPi);
      int32_t layer = ring ? ring[i] : 0;
      if (layer < 0) layer = 0;
      if (layer >= p->num_scan_lines) layer = p->num_scan_lines - 1;
      if (std::isnan(yaw_fp[layer])) yaw_fp[layer] = yaw;
      double diff = std::fmod(yaw_fp[layer] - yaw, p->angle_limit);
      if (diff < 0) diff += p->angle_limit;
      rel[k] = diff / ang_vel / 1000.0;  // s
    }
  }

  // 3. anchor at scan start
  double t0 = std::numeric_limits<double>::infinity();
  for (double r : rel) t0 = std::min(t0, r);
  if (!std::isfinite(t0)) t0 = 0.0;
  for (double& r : rel) r -= t0;

  // 4. stable sort by relative time (reference sort_clouds, frame.cpp:28-51)
  std::vector<int32_t> order(keep.size());
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return rel[a] < rel[b]; });

  // 5. pad + normalize
  const int32_t cap = p->max_points;
  const int32_t m = std::min<int32_t>(int32_t(order.size()), cap);
  std::memset(out_xyz, 0, sizeof(float) * 3 * cap);
  std::memset(out_tau, 0, sizeof(float) * cap);
  std::memset(out_rel, 0, sizeof(double) * cap);
  std::memset(out_mask, 0, sizeof(uint8_t) * cap);

  double span = 0.0;
  for (int32_t k = 0; k < m; ++k) span = std::max(span, rel[order[k]]);
  const double denom = span > 0 ? span : 1.0;

  for (int32_t k = 0; k < m; ++k) {
    const int32_t src = keep[order[k]];
    out_xyz[3 * k] = xyz[3 * src];
    out_xyz[3 * k + 1] = xyz[3 * src + 1];
    out_xyz[3 * k + 2] = xyz[3 * src + 2];
    out_rel[k] = rel[order[k]];
    out_tau[k] = float(rel[order[k]] / denom);
    out_mask[k] = 1;
  }
  *t_begin = p->stamp + t0;
  *t_end = p->stamp + t0 + span;
  return m;
}

// Voxel downsample on the host (first point per voxel, truncation-toward-
// zero voxel index — reference icp.cpp:9-30 + calculation_helpers.cpp:142-147).
// Useful for host-side keyframe cloud thinning. Returns number of output
// points written (<= out_cap).
int voxel_downsample(const float* xyz, int32_t n, double voxel_size,
                     float* out_xyz, int32_t out_cap) {
  // open addressing on the packed 63-bit key
  const size_t table_size = size_t(1) << 20;
  std::vector<int64_t> table(table_size, -1);
  auto pack = [](int32_t x, int32_t y, int32_t z) -> int64_t {
    const int64_t off = 1 << 20, mask = (1 << 21) - 1;
    return (((int64_t(x) + off) & mask) << 42) |
           (((int64_t(y) + off) & mask) << 21) | ((int64_t(z) + off) & mask);
  };
  int32_t m = 0;
  for (int32_t i = 0; i < n && m < out_cap; ++i) {
    const int32_t vx = int32_t(xyz[3 * i] / voxel_size);
    const int32_t vy = int32_t(xyz[3 * i + 1] / voxel_size);
    const int32_t vz = int32_t(xyz[3 * i + 2] / voxel_size);
    const int64_t key = pack(vx, vy, vz);
    const uint32_t h =
        (uint32_t(vx) * 73856093u ^ uint32_t(vy) * 19349663u ^
         uint32_t(vz) * 83492791u);
    size_t slot = h & (table_size - 1);
    bool fresh = false;
    for (size_t probe = 0; probe < table_size; ++probe) {
      int64_t cur = table[slot];
      if (cur == key) break;
      if (cur == -1) {
        table[slot] = key;
        fresh = true;
        break;
      }
      slot = (slot + 1) & (table_size - 1);
    }
    if (fresh) {
      out_xyz[3 * m] = xyz[3 * i];
      out_xyz[3 * m + 1] = xyz[3 * i + 1];
      out_xyz[3 * m + 2] = xyz[3 * i + 2];
      ++m;
    }
  }
  return m;
}

}  // extern "C"
