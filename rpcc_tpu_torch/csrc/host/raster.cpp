// Host projection: fused binning + keep-nearest scatter-min onto the range
// image grid.
//
// The production encode path projects on the host and uploads the (H, W)
// range image — 3x fewer bytes than the raw cloud and no device-side
// compaction sorts.  Semantics match the reference host kernel
// (cpp_modules.cpp:427-467: write if empty or strictly nearer — first
// writer wins exact ties) and the device sort path
// (ops/projection.py::_scatter_min_image).
//
// BIT-EXACTNESS: this file is the scalar twin of the numpy fallback in
// ops/projection.py (bin_points_host / _atan2_det).  Angles and depth are
// computed in double with an identical +,-,*,/ sequence (each op IEEE
// exact-rounded, so both implementations produce identical bits); binning
// runs in float with the same op order.  Keep the coefficient list below in
// sync with _ATAN_COEFFS.  Built with -ffp-contract=off so the compiler
// cannot fuse a*b+c into FMA and break the equivalence.

#include <cmath>
#include <cstdint>

namespace {

constexpr double kAtanW8 = 0.41421356237309503;  // tan(pi/8)
constexpr double kAtanC[9] = {
    0.999999999999762,
    -0.3333333332494847,
    0.19999999129892043,
    -0.14285673103306398,
    0.11110049848756427,
    -0.09074709961180911,
    0.07540656567851425,
    -0.05797933104322553,
    0.02961455500835997,
};
constexpr double kPi = 3.141592653589793;
// Reference wrap constant (transformer.py:64: az += 2*3.14159265).
constexpr float kTwoPiRef = 2.0f * 3.14159265f;

// Branchless (select-style) and loop-free so gcc can auto-vectorize the
// binning pass; identical op sequence to the numpy fallback
// (projection.py::_atan2_det).
inline double atan2_det(double y, double x) {
  double ay = std::fabs(y), ax = std::fabs(x);
  bool swap = ay > ax;
  double num = swap ? ax : ay;
  double den = swap ? ay : ax;
  double t = num / (den == 0.0 ? 1.0 : den);  // numpy guards the same way
  bool red = t > kAtanW8;
  double u = red ? (t - 1.0) / (t + 1.0) : t;
  double u2 = u * u;
  double p = kAtanC[8];
  p = p * u2 + kAtanC[7];
  p = p * u2 + kAtanC[6];
  p = p * u2 + kAtanC[5];
  p = p * u2 + kAtanC[4];
  p = p * u2 + kAtanC[3];
  p = p * u2 + kAtanC[2];
  p = p * u2 + kAtanC[1];
  p = p * u2 + kAtanC[0];
  double a = u * p + (red ? kPi / 4 : 0.0);
  a = swap ? kPi / 2 - a : a;
  a = (x < 0) ? kPi - a : a;
  a = (y < 0) ? -a : a;
  return (den == 0.0) ? 0.0 : a;
}

inline float round_half_away(float v) {
  return truncf(v + (v >= 0.0f ? 0.5f : -0.5f));
}

}  // namespace

extern "C" void raster_scatter_min(const float *depth, const int32_t *idx,
                                   int64_t n, float *ri, int64_t hw) {
  for (int64_t i = 0; i < n; ++i) {
    float d = depth[i];
    if (!(d > 0.0f)) continue;  // padding / degenerate points never write
    int32_t k = idx[i];
    if (k < 0 || k >= hw) continue;
    float cur = ri[k];
    if (cur == 0.0f || d < cur) ri[k] = d;
  }
}

// Fused bin + raster.  pts is (n, stride) row-major with x,y,z leading;
// ri must be zero-initialized with H*W floats.  For even-distribution
// lidars pass v_angles == nullptr; for CSV lidars pass the f32 radian
// table (np.radians(deg f64).astype(f32)) and its length n_chan.
extern "C" void project_bin_raster(const float *pts, int64_t n, int64_t stride,
                                   int32_t H, int32_t W, int32_t even_dist,
                                   float hfov, float vmin, float vres,
                                   const float *v_angles, int32_t n_chan,
                                   float *ri) {
  const float Wf = (float)W;
  const int64_t hw = (int64_t)H * W;
  constexpr int CHUNK = 2048;  // L1-resident temporaries
  float xb[CHUNK], yb[CHUNK], zb[CHUNK];
  float az_buf[CHUNK], v_buf[CHUNK], depth_buf[CHUNK];
  int32_t idx_buf[CHUNK], c_buf[CHUNK], row_buf[CHUNK];
  for (int64_t base = 0; base < n; base += CHUNK) {
    const int m = (int)((n - base < CHUNK) ? (n - base) : CHUNK);
    // Pass A0: de-interleave the (runtime-)strided cloud into contiguous
    // buffers — the strided load is what blocks vectorization of the math.
    // Duplicated for the two production strides (4: xyzi clouds viewed as
    // (N, 4); 3: packed xyz) so gcc sees a literal stride and vectorizes
    // the shuffle (~1.0 ns/pt saved vs the runtime-stride loop).
    if (stride == 4) {
      const float *p = pts + base * 4;
      for (int i = 0; i < m; ++i) {
        xb[i] = p[i * 4];
        yb[i] = p[i * 4 + 1];
        zb[i] = p[i * 4 + 2];
      }
    } else if (stride == 3) {
      const float *p = pts + base * 3;
      for (int i = 0; i < m; ++i) {
        xb[i] = p[i * 3];
        yb[i] = p[i * 3 + 1];
        zb[i] = p[i * 3 + 2];
      }
    } else {
      for (int i = 0; i < m; ++i) {
        const float *p = pts + (base + i) * stride;
        xb[i] = p[0];
        yb[i] = p[1];
        zb[i] = p[2];
      }
    }
    // Pass A1 (the ~90%: two atan2 + two sqrt per point): pure float/double
    // arithmetic with selects only — gcc vectorizes this with 64-byte
    // vectors.  Int conversions live in A2 so they cannot poison it.
    for (int i = 0; i < m; ++i) {
      double x64 = (double)xb[i], y64 = (double)yb[i], z64 = (double)zb[i];
      double xx = x64 * x64;
      double h2 = xx + y64 * y64;
      double d2 = h2 + z64 * z64;
      float az = (float)atan2_det(y64, x64);
      az_buf[i] = (az < 0.0f) ? az + kTwoPiRef : az;
      v_buf[i] = (float)atan2_det(z64, std::sqrt(h2));
      depth_buf[i] = (float)std::sqrt(d2);
    }
    // Pass A2: binning.  az >= 0 after the wrap, so the raw column is
    // almost always in [0, 2W) and the floored modulo reduces to one
    // conditional subtract (the integer division would cost more than the
    // whole pass); out-of-range stragglers (limited-FOV lidars) take the
    // exact numpy floored-% path.
    if (even_dist) {
      // The `%` fixup is hoisted into a separate straggler pass: a runtime-W
      // integer modulo in the loop body blocks auto-vectorization of the
      // whole pass (~4.4 ns/pt).  The main loop is select-only; stragglers
      // (limited-FOV lidars — zero on full-360 scans) are patched with the
      // exact same floored-% integer math afterwards, so the result is
      // bit-identical either way.
      int n_bad = 0;
      for (int i = 0; i < m; ++i) {
        int32_t c = (int32_t)round_half_away(az_buf[i] / hfov * Wf);
        int32_t col = (c >= W) ? c - W : c;
        n_bad += ((uint32_t)col >= (uint32_t)W);
        c_buf[i] = c;
        int32_t row = (int32_t)round_half_away((v_buf[i] - vmin) / vres);
        row = (row < 0) ? 0 : row;
        row = (row > H - 1) ? H - 1 : row;
        row_buf[i] = row;
        idx_buf[i] = row * W + col;
      }
      if (n_bad) {
        for (int i = 0; i < m; ++i) {
          int32_t c = c_buf[i];
          int32_t col = (c >= W) ? c - W : c;
          if ((uint32_t)col >= (uint32_t)W) {
            col = ((c % W) + W) % W;
            idx_buf[i] = row_buf[i] * W + col;
          }
        }
      }
    } else {
      for (int i = 0; i < m; ++i) {
        int32_t c = (int32_t)rintf(az_buf[i] / hfov * Wf);  // half-even
        int32_t col = (c >= W) ? c - W : c;
        if ((uint32_t)col >= (uint32_t)W) col = ((c % W) + W) % W;
        float v_ang = v_buf[i];
        int32_t row = 0;
        float best = std::fabs(v_angles[0] - v_ang);
        for (int32_t j = 1; j < n_chan; ++j) {
          float ad = std::fabs(v_angles[j] - v_ang);
          row = (ad < best) ? j : row;
          best = (ad < best) ? ad : best;
        }
        idx_buf[i] = row * W + col;
      }
    }
    // Pass B: scalar keep-nearest scatter (a branchless select+store
    // variant A/B'd identical — the grid is L2-resident and the branch
    // predicts well; pinned negative result, don't retry).
    for (int i = 0; i < m; ++i) {
      float d = depth_buf[i];
      if (!(d > 0.0f)) continue;
      int64_t k = idx_buf[i];
      if (k < 0 || k >= hw) continue;
      float cur = ri[k];
      if (cur == 0.0f || d < cur) ri[k] = d;
    }
  }
}

// u16 transfer variant: project, then snap depths to a per-frame grid
// delta = max(step_over16, depth_max/65535) (bit-identical to the numpy
// fallback in parallel/engine.py::_stack — f64 max math, f32 reciprocal
// multiply, rint half-even, 65535 clamp).  ri_scratch must hold H*W zeroed
// floats; out gets H*W u16; *delta_out the chosen grid.
extern "C" void project_bin_raster_u16(
    const float *pts, int64_t n, int64_t stride, int32_t H, int32_t W,
    int32_t even_dist, float hfov, float vmin, float vres,
    const float *v_angles, int32_t n_chan, float step_over16,
    float *ri_scratch, uint16_t *out, float *delta_out) {
  project_bin_raster(pts, n, stride, H, W, even_dist, hfov, vmin, vres,
                     v_angles, n_chan, ri_scratch);
  const int64_t hw = (int64_t)H * W;
  float mx = 0.0f;
  for (int64_t i = 0; i < hw; ++i) mx = (ri_scratch[i] > mx) ? ri_scratch[i] : mx;
  double alt = (double)mx / 65535.0;
  double fl = (double)step_over16;
  float d = (float)(alt > fl ? alt : fl);
  float inv = 1.0f / d;
  for (int64_t i = 0; i < hw; ++i) {
    float q = rintf(ri_scratch[i] * inv);
    q = (q > 65535.0f) ? 65535.0f : q;
    out[i] = (uint16_t)q;
  }
  *delta_out = d;
}

// i8 row-delta transfer variant: u16-snap as above, then first-difference
// the flattened q grid into an i8 plane plus a compact exception list.
// An exception is emitted at column 0 of every row (bounds the position
// gap and resets the cumsum chain) and wherever the delta falls outside
// [-128, 127]; its d8 slot is 0, and (pos_delta u16, absolute q u16) go to
// the side lists.  The device inverts with two cumsums + one small scatter
// (models/encoder.py ri_d8 path): q = cumsum(d8) + cumsum(scatter(K-diffs))
// where K_e = q_e - cumsum(d8)[e].  ~11 MB per 64-frame KITTI batch vs
// 16 MB for raw u16 — the uplink wire is the e2e encode ceiling on this
// rig.  Returns the exception count; exc buffers must hold H*W entries
// (worst case).  Bit-identical to the numpy fallback (same rule, same q).
extern "C" int64_t project_bin_raster_d8(
    const float *pts, int64_t n, int64_t stride, int32_t H, int32_t W,
    int32_t even_dist, float hfov, float vmin, float vres,
    const float *v_angles, int32_t n_chan, float step_over16,
    float *ri_scratch, uint16_t *q_scratch, float *delta_out,
    int8_t *d8_out, uint16_t *exc_pd, uint16_t *exc_val) {
  project_bin_raster_u16(pts, n, stride, H, W, even_dist, hfov, vmin, vres,
                         v_angles, n_chan, step_over16, ri_scratch, q_scratch,
                         delta_out);
  const int64_t hw = (int64_t)H * W;
  int64_t n_exc = 0;
  int32_t prev_q = 0;
  int64_t prev_pos = -1;
  int64_t p = 0;
  for (int32_t r = 0; r < H; ++r) {
    for (int32_t c = 0; c < W; ++c, ++p) {
      int32_t q = (int32_t)q_scratch[p];
      int32_t dlt = q - prev_q;
      if (c != 0 && dlt >= -128 && dlt <= 127) {
        d8_out[p] = (int8_t)dlt;
      } else {
        d8_out[p] = 0;
        exc_pd[n_exc] = (uint16_t)(p - prev_pos);
        exc_val[n_exc] = (uint16_t)q;
        prev_pos = p;
        ++n_exc;
      }
      prev_q = q;
    }
  }
  return n_exc;
}

// m8 masked-compact transfer variant: u16-snap, then drop the zero pixels
// from the wire entirely — a packed MSB-first occupancy bit plane plus i8
// first-differences over *consecutive nonzero* pixels.  Exceptions (d8c
// slot 0, (pos-delta u16, absolute q u16) side lists, positions in the
// COMPACT domain) are the first nonzero pixel of each row — bounding
// exception pos-gaps by W so u16 never overflows — and any compact delta
// outside [-128, 127].  The device inverts in the compact domain with the
// same two-cumsum + small-scatter as ri_d8, then expands through the mask
// with one rank-indexed gather (models/encoder.py ri_m8 path).  ~8.4 MB
// per 64-frame KITTI batch vs ~11.3 for 'i8'.  Bit-identical to the numpy
// path in ops/projection.py::project_points_host_m8.  d8c/exc buffers
// must hold H*W entries (worst case); maskp must hold hw/8 bytes and hw
// must be a multiple of 8 (range images are).  Writes the nonzero count
// to *n_nz_out and returns the exception count.
extern "C" int64_t project_bin_raster_m8(
    const float *pts, int64_t n, int64_t stride, int32_t H, int32_t W,
    int32_t even_dist, float hfov, float vmin, float vres,
    const float *v_angles, int32_t n_chan, float step_over16,
    float *ri_scratch, uint16_t *q_scratch, float *delta_out,
    uint8_t *maskp_out, int8_t *d8c_out, uint16_t *exc_pd,
    uint16_t *exc_val, int64_t *n_nz_out) {
  project_bin_raster_u16(pts, n, stride, H, W, even_dist, hfov, vmin, vres,
                         v_angles, n_chan, step_over16, ri_scratch, q_scratch,
                         delta_out);
  int64_t nnz = 0, n_exc = 0, prev_exc_rank = -1;
  int32_t prev_q = 0;
  int64_t p = 0;
  uint8_t byte = 0;
  for (int32_t r = 0; r < H; ++r) {
    bool row_first = true;
    for (int32_t c = 0; c < W; ++c, ++p) {
      const int32_t q = (int32_t)q_scratch[p];
      const int k = (int)(p & 7);
      if (q != 0) {
        byte |= (uint8_t)(0x80u >> k);
        const int32_t dlt = q - prev_q;
        if (!row_first && dlt >= -128 && dlt <= 127) {
          d8c_out[nnz] = (int8_t)dlt;
        } else {
          d8c_out[nnz] = 0;
          exc_pd[n_exc] = (uint16_t)(nnz - prev_exc_rank);
          exc_val[n_exc] = (uint16_t)q;
          prev_exc_rank = nnz;
          ++n_exc;
        }
        prev_q = q;
        row_first = false;
        ++nnz;
      }
      if (k == 7) {
        maskp_out[p >> 3] = byte;
        byte = 0;
      }
    }
  }
  *n_nz_out = nnz;
  return n_exc;
}
