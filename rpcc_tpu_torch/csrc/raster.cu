// The single-frame codec's projection for Hopper (sm_90a), plain C ABI:
// an (N, stride) f32 cloud -> the encoder's (H, W) input on the card.
//
// Replaces no TPU kernel.  The reference projects on the host
// (csrc/host/raster.cpp, the native twin of the reference's C++ kernel) and
// in jnp (rpcc_tpu/ops/projection.py); the port's single-frame codec
// (models/pipeline.py::RPCCCodec) ran raster.cpp on one host thread, ~2 ms
// a 64E sweep while the card sat idle, then uploaded the grid.  This kernel
// is that projection on the card, so the raw cloud is the only upload.
//
// BIT-EXACTNESS: the result equals project_bin_raster (f32 transfer) and
// project_bin_raster_u16 (the u16 snap) of csrc/host/raster.cpp for every
// finite cloud.  Angles and depth are computed in double with the host's
// +, -, *, / sequence and binned in float in the host's order, every
// operation through a round-to-nearest intrinsic (__dadd_rn, __fmul_rn,
// ...), which nvcc never contracts into an FMA: the card's equivalent of
// the host's -ffp-contract=off.  The rules copied: the deterministic atan2
// polynomial (keep kAtan* in step with raster.cpp), the 2*3.14159265
// azimuth wrap, half-away rows and columns for evenly spaced rows, half-even
// columns and the nearest channel angle (first index on ties) for a channel
// table, the floored-modulo rule for columns outside [0, W), points whose
// depth is not > 0 skipped.
//
// Keep-nearest: an atomicMin on the depth's bits.  Every depth written is
// > 0, and positive floats order as their bits do, so the minimum is the
// host's "write if empty or strictly nearer"; equal depths are equal bits,
// so which of them "wins" cannot show.  An empty pixel holds 0xFFFFFFFF.
//
// What bounds it: the cloud read once (12 B a point: 1.536 MB at 128,000
// points) and the grid written once (4 B a pixel, 0.512 MB at 64x2000):
// 2.05 MB, 0.61 us at 3.35 TB/s; the ~70 double operations a point (two
// atan2 polynomials, two sqrt, a divide each) are 9 M at 128,000 points,
// 0.27 us at 34 TFLOP/s.  Bytes bound it, and at this size two launches'
// latency and the one serial reduction are most of its time.
//
// Design: two launches a frame and no memset.
//   1. project_scatter_kernel, a thread a point: bins the point and
//      atomicMins its depth into the scratch image.  Every block then takes
//      a ticket; the last block to finish (the threadfence-reduction
//      pattern: each thread fences its atomics, the ticket is an atomic)
//      reads the finished image from L2 (1,024 threads, four 16-byte loads
//      in flight each) and writes the frame's delta, the
//      u16 grid's step max(max depth / 65535, step / 16) in double as the
//      host computes it (1 for the f32 transfer), and resets the ticket.
//   2. project_snap_kernel, a thread a pixel: q = min(rint(ri * (1 / delta)),
//      65535) as int32, or the f32 depth, 0 where empty; and resets its
//      scratch pixel to empty for the next frame.
// The scratch image and the ticket belong to the caller's workspace
// (ops/projection_device.py): filled once when it is made, left as found.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScatterThreads = 1024;
constexpr int kSnapThreads = 256;
constexpr unsigned kEmpty = 0xFFFFFFFFu;

constexpr double kAtanW8 = 0.41421356237309503;  // tan(pi/8)
constexpr double kPi = 3.141592653589793;
// Reference wrap constant (transformer.py:64: az += 2*3.14159265).
constexpr float kTwoPiRef = 2.0f * 3.14159265f;

struct Args {
  const float *pts;
  int64_t n;
  int64_t stride;
  int H, W;
  int even_dist;
  float hfov, vmin, vres;
  const float *v_angles;
  int n_chan;
  int snap_u16;
  float step_over16;
  unsigned *scratch;
  unsigned *ticket;
  void *grid;
  float *delta;
};

__device__ __forceinline__ double horner(double p, double u2, double c) {
  return __dadd_rn(__dmul_rn(p, u2), c);
}

// raster.cpp::atan2_det, operation for operation.
__device__ __forceinline__ double atan2_det(double y, double x) {
  const double ay = fabs(y), ax = fabs(x);
  const bool swap = ay > ax;
  const double num = swap ? ax : ay;
  const double den = swap ? ay : ax;
  const double t = __ddiv_rn(num, den == 0.0 ? 1.0 : den);
  const bool red = t > kAtanW8;
  const double u = red ? __ddiv_rn(__dsub_rn(t, 1.0), __dadd_rn(t, 1.0)) : t;
  const double u2 = __dmul_rn(u, u);
  double p = 0.02961455500835997;
  p = horner(p, u2, -0.05797933104322553);
  p = horner(p, u2, 0.07540656567851425);
  p = horner(p, u2, -0.09074709961180911);
  p = horner(p, u2, 0.11110049848756427);
  p = horner(p, u2, -0.14285673103306398);
  p = horner(p, u2, 0.19999999129892043);
  p = horner(p, u2, -0.3333333332494847);
  p = horner(p, u2, 0.999999999999762);
  double a = __dadd_rn(__dmul_rn(u, p), red ? kPi / 4 : 0.0);
  a = swap ? __dsub_rn(kPi / 2, a) : a;
  a = (x < 0) ? __dsub_rn(kPi, a) : a;
  a = (y < 0) ? -a : a;
  return (den == 0.0) ? 0.0 : a;
}

__device__ __forceinline__ float round_half_away(float v) {
  return truncf(__fadd_rn(v, v >= 0.0f ? 0.5f : -0.5f));
}

__global__ void __launch_bounds__(kScatterThreads) project_scatter_kernel(Args a) {
  const int64_t i = (int64_t)blockIdx.x * kScatterThreads + threadIdx.x;
  const int64_t hw = (int64_t)a.H * a.W;
  if (i < a.n) {
    const float *p = a.pts + i * a.stride;
    const double x64 = (double)p[0], y64 = (double)p[1], z64 = (double)p[2];
    const double h2 = __dadd_rn(__dmul_rn(x64, x64), __dmul_rn(y64, y64));
    const double d2 = __dadd_rn(h2, __dmul_rn(z64, z64));
    float az = __double2float_rn(atan2_det(y64, x64));
    az = (az < 0.0f) ? __fadd_rn(az, kTwoPiRef) : az;
    const float v = __double2float_rn(atan2_det(z64, __dsqrt_rn(h2)));
    const float d = __double2float_rn(__dsqrt_rn(d2));
    if (d > 0.0f) {
      const float col_f = __fmul_rn(__fdiv_rn(az, a.hfov), (float)a.W);
      int c, row;
      if (a.even_dist) {
        c = (int)round_half_away(col_f);
        row = (int)round_half_away(__fdiv_rn(__fsub_rn(v, a.vmin), a.vres));
        row = (row < 0) ? 0 : row;
        row = (row > a.H - 1) ? a.H - 1 : row;
      } else {
        c = (int)rintf(col_f);  // half-even
        row = 0;
        float best = fabsf(__fsub_rn(__ldg(a.v_angles), v));
        for (int j = 1; j < a.n_chan; ++j) {
          const float ad = fabsf(__fsub_rn(__ldg(a.v_angles + j), v));
          row = (ad < best) ? j : row;
          best = (ad < best) ? ad : best;
        }
      }
      int col = (c >= a.W) ? c - a.W : c;
      if ((unsigned)col >= (unsigned)a.W) col = ((c % a.W) + a.W) % a.W;
      const int64_t k = (int64_t)row * a.W + col;
      if (k >= 0 && k < hw) atomicMin(a.scratch + k, __float_as_uint(d));
    }
  }

  // The last block to finish sees every atomic: each thread fences its own,
  // the ticket is taken after the block's barrier.
  __shared__ bool last;
  __shared__ unsigned warp_max[kScatterThreads / 32];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (!a.snap_u16) {
    if (threadIdx.x == 0) {
      *a.delta = 1.0f;
      *a.ticket = 0u;
    }
    return;
  }
  // The image's largest depth (as bits; empty pixels count as 0), read
  // past L1 from where the atomics left it.
  unsigned mx = 0u;
  const int64_t n4 = hw / 4;
  const uint4 *s4 = reinterpret_cast<const uint4 *>(a.scratch);
#pragma unroll 4
  for (int64_t k = threadIdx.x; k < n4; k += kScatterThreads) {
    const uint4 s = __ldcg(s4 + k);
    mx = max(mx, s.x == kEmpty ? 0u : s.x);
    mx = max(mx, s.y == kEmpty ? 0u : s.y);
    mx = max(mx, s.z == kEmpty ? 0u : s.z);
    mx = max(mx, s.w == kEmpty ? 0u : s.w);
  }
  for (int64_t k = n4 * 4 + threadIdx.x; k < hw; k += kScatterThreads) {
    const unsigned s = __ldcg(a.scratch + k);
    mx = max(mx, s == kEmpty ? 0u : s);
  }
  mx = __reduce_max_sync(0xFFFFFFFFu, mx);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = (threadIdx.x < kScatterThreads / 32) ? warp_max[threadIdx.x] : 0u;
    mx = __reduce_max_sync(0xFFFFFFFFu, mx);
    if (threadIdx.x == 0) {
      // raster.cpp::project_bin_raster_u16: f64 max, then f32.
      const double alt = __ddiv_rn((double)__uint_as_float(mx), 65535.0);
      const double fl = (double)a.step_over16;
      *a.delta = __double2float_rn(alt > fl ? alt : fl);
      *a.ticket = 0u;
    }
  }
}

__global__ void __launch_bounds__(kSnapThreads) project_snap_kernel(Args a) {
  const int64_t k = (int64_t)blockIdx.x * kSnapThreads + threadIdx.x;
  if (k >= (int64_t)a.H * a.W) return;
  const unsigned s = a.scratch[k];
  a.scratch[k] = kEmpty;
  const float ri = (s == kEmpty) ? 0.0f : __uint_as_float(s);
  if (!a.snap_u16) {
    static_cast<float *>(a.grid)[k] = ri;
    return;
  }
  const float inv = __fdiv_rn(1.0f, *a.delta);
  float q = rintf(__fmul_rn(ri, inv));
  q = (q > 65535.0f) ? 65535.0f : q;
  static_cast<int32_t *>(a.grid)[k] = (int32_t)q;
}

}  // namespace

// Projects pts (n rows of `stride` floats, x, y, z leading) on `stream`:
// grid gets the (H, W) int32 u16 snap grid (snap_u16) or the f32 range
// image, *delta its step (1 for the f32 range image).  scratch holds H*W
// words of 0xFFFFFFFF and ticket a 0, and both are left so.  v_angles is
// the f32 channel table (n_chan = H entries) when even_dist is 0.  Returns
// the launches' cudaError_t.
extern "C" int rpcc_project_launch(const float *pts, int64_t n, int64_t stride, int H, int W,
                                   int even_dist, float hfov, float vmin, float vres,
                                   const float *v_angles, int n_chan, int snap_u16,
                                   float step_over16, unsigned *scratch, unsigned *ticket,
                                   void *grid, float *delta, cudaStream_t stream) {
  const Args a{pts, n, stride, H, W, even_dist, hfov, vmin, vres, v_angles, n_chan,
               snap_u16, step_over16, scratch, ticket, grid, delta};
  const int64_t hw = (int64_t)H * W;
  const int64_t blocks = n > 0 ? (n + kScatterThreads - 1) / kScatterThreads : 1;
  project_scatter_kernel<<<(unsigned)blocks, kScatterThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  project_snap_kernel<<<(unsigned)((hw + kSnapThreads - 1) / kSnapThreads), kSnapThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
