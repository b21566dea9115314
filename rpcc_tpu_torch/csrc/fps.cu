// Batched farthest-point sampling for Hopper (sm_90a), plain C ABI: one
// thread-block cluster per frame.
//
// Replaces the TPU kernel rpcc_tpu/ops/fps_pallas.py::_fps_kernel.  Same
// semantics as that kernel and as the plain PyTorch version
// (rpcc_tpu_torch/ops/fps.py::furthest_point_sample_planar):
//   * the first pick is index 0; the running min squared distance starts
//     at 1e10;
//   * each of the K-1 steps updates min-d2 with d2 = (dx*dx + dy*dy) + dz*dz
//     and picks its argmax, the larger value first and, on equal values,
//     the lower index of the frame.
// With a per-frame count (num_valid, read on the device) it computes the
// masked FPS of rpcc_tpu/ops/fps.py::furthest_point_sample_planar_masked
// (the cpu_fps mode, over a compacted point list): the seed is still index
// 0, and points at or past the frame's count never win, as if their min-d2
// were pinned at -1.  Every valid min-d2 is >= 0 > -1, so with a count of at
// least 1 that is FPS over the first `count` points alone; with a count of
// 0 every value is -1 and every pick is index 0, which is FPS over point 0
// alone.  So only the points below max(count, 1) take part, and their
// arithmetic and ordering are the unmasked kernel's.
// d2 is computed with __fsub_rn/__fmul_rn/__fadd_rn so no FMA contraction
// changes a near-tie against the plain version: the indices are equal.
//
// What bounds it: the main path's (1, 128000, 100) is 99 x 128,000
// point-steps of 9 f32 operations, 114 M operations or 1.7 us at the
// card's 67 TFLOP/s, against 1.5 MB of coordinates read once (0.46 us at
// 3.35 TB/s): compute-bound at ~1.7 us.  But the 99 steps are strictly
// dependent, and each ends in an argmax over the whole frame, so a step
// costs at least one reduction across the SMs that hold the frame: some
// 0.5-1 us each, a latency floor of 0.05-0.1 ms that no roofline sees.
// The TPU kernel keeps the frame in VMEM; one SM's 227 KB holds an eighth
// of a 64E frame's coordinates and min-d2.
//
// Design: a frame is spread over a cluster of C = 8 or 16 CTAs of 1024
// threads (the wrapper picks C from the occupancy query), whose 8-16 SMs
// together hold it on chip.  CTA r owns the contiguous points
// [r * chunk, (r + 1) * chunk), chunk = ceil(N / C):
//   * it stages their x/y/z into dynamic shared memory once, and keeps
//     min-d2 in registers, kRegPts per thread: up to kThreads * kRegPts =
//     16,384 points a CTA (8,000 of a 64E frame at C = 16, 16,000 at
//     C = 8).  Points beyond that stream x/y/z from device memory and
//     min-d2 from a scratch buffer, in the same kernel;
//   * a step is one pass over the CTA's points keeping a per-thread
//     (value, index) best, and a block argmax with warp shuffles; warp 0
//     then stores the CTA's candidate (value, index, x, y, z) through
//     distributed shared memory into slot [parity][rank] of every CTA of
//     the cluster (C remote stores, no remote load on the critical path);
//   * one cluster barrier (barrier.cluster.arrive.release / wait.acquire)
//     makes the C candidates visible; every warp of every CTA reduces them
//     from its own shared memory with the same rule, so each learns the
//     winner and its coordinates with no device-memory read and no second
//     block barrier.  Rank 0 writes out[b, i].  Slots alternate by step
//     parity: a CTA stores into slot p again only after the next barrier,
//     which every reader of slot p has passed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRegPts = 16;  // min-d2 registers per thread: ops/fps.py::REG_PTS
constexpr int kMaxCluster = 16;

// A CTA's best point of a step.  Every min-d2 is >= +0, so the order of the
// f32 bit patterns as unsigned integers is the order of the values; a CTA
// with no points taking part sends (0, INT_MAX), which every real point
// beats (a min-d2 of +0 on its index).
struct Candidate {
  unsigned v;  // __float_as_uint(min-d2)
  int i;       // index in the frame
  float x, y, z;
};

// (v, i) beats (bv, bi): larger value first, lower index on equal values.
__device__ __forceinline__ void take_better(unsigned& bv, int& bi, unsigned v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Argmax over a warp with the same rule, in two warp reductions: the
// largest value, then the lowest index holding it.  Every lane gets both.
__device__ __forceinline__ void warp_argmax(unsigned& v, int& i) {
  const unsigned m = __reduce_max_sync(0xffffffffu, v);
  i = __reduce_min_sync(0xffffffffu, v == m ? i : INT_MAX);
  v = m;
}

__device__ __forceinline__ float dist2(float x, float y, float z, float x0, float y0, float z0) {
  const float dx = __fsub_rn(x, x0);
  const float dy = __fsub_rn(y, y0);
  const float dz = __fsub_rn(z, z0);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Grid: B * C CTAs of kThreads, clusters of C along x (one per frame).
// scratch: (B, C, spill) f32, min-d2 of the points past each CTA's
// on-chip share (spill = chunk - on-chip points, may be 0).  num_valid:
// (B,) i32 counts, or nullptr for all n points of every frame.
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ zs, const int32_t* __restrict__ num_valid,
                   int n, int k, int chunk, int spill, float* __restrict__ scratch,
                   int32_t* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / C;
  xs += b * n;
  ys += b * n;
  zs += b * n;
  out += b * k;
  scratch += (b * C + rank) * static_cast<size_t>(spill);

  extern __shared__ float s_xyz[];
  __shared__ Candidate s_slot[2][kMaxCluster];  // [step parity][rank of the sender]
  __shared__ unsigned s_val[kWarps];
  __shared__ int s_idx[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = rank * chunk;
  const int nloc = max(0, min(chunk, n - base));
  const int nchip = min(nloc, kThreads * kRegPts);  // the layout: set by n alone
  const int nover = nloc - nchip;
  float* sx = s_xyz;
  float* sy = sx + nchip;
  float* sz = sy + nchip;
  // The points taking part: [0, max(count, 1)) of the frame (see the top).
  const int nact = num_valid == nullptr ? n : min(max(num_valid[b], 1), n);
  const int achip = max(0, min(nchip, nact - base));
  const int aover = max(0, min(nover, nact - base - nchip));

  float md[kRegPts];
#pragma unroll
  for (int t = 0; t < kRegPts; ++t) {
    const int j = tid + t * kThreads;
    md[t] = 1e10f;
    if (j < achip) {
      sx[j] = xs[base + j];
      sy[j] = ys[base + j];
      sz[j] = zs[base + j];
    }
  }
  for (int j = tid; j < aover; j += kThreads) scratch[j] = 1e10f;
  if (rank == 0 && tid == 0) out[0] = 0;
  float x0 = xs[0];
  float y0 = ys[0];
  float z0 = zs[0];
  // Every CTA of the cluster has started before the first remote store, and
  // the staged points are visible to every thread of the CTA.
  cluster.sync();

  for (int i = 1; i < k; ++i) {
    unsigned bv = 0u;
    int bi = INT_MAX;
#pragma unroll
    for (int t = 0; t < kRegPts; ++t) {
      const int j = tid + t * kThreads;
      if (j < achip) {
        const float m = fminf(md[t], dist2(sx[j], sy[j], sz[j], x0, y0, z0));
        md[t] = m;
        take_better(bv, bi, __float_as_uint(m), base + j);
      }
    }
    for (int j = tid; j < aover; j += kThreads) {
      const int g = base + nchip + j;
      const float m = fminf(scratch[j], dist2(xs[g], ys[g], zs[g], x0, y0, z0));
      scratch[j] = m;
      take_better(bv, bi, __float_as_uint(m), g);
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    const int par = i & 1;
    if (warp == 0) {
      bv = lane < kWarps ? s_val[lane] : 0u;
      bi = lane < kWarps ? s_idx[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane < C) {  // push this CTA's candidate into slot `rank` of CTA `lane`
        Candidate c{bv, bi, 0.0f, 0.0f, 0.0f};
        if (bi != INT_MAX) {
          const int off = bi - base;
          c.x = off < achip ? sx[off] : xs[bi];
          c.y = off < achip ? sy[off] : ys[bi];
          c.z = off < achip ? sz[off] : zs[bi];
        }
        *cluster.map_shared_rank(&s_slot[par][rank], lane) = c;
      }
    }
    cluster.sync();
    // Every warp reduces the C candidates in its own shared memory.
    unsigned v = 0u;
    int idx = INT_MAX;
    if (lane < C) {
      v = s_slot[par][lane].v;
      idx = s_slot[par][lane].i;
    }
    const int mine = idx;
    warp_argmax(v, idx);
    const Candidate& w = s_slot[par][__ffs(__ballot_sync(0xffffffffu, lane < C && mine == idx)) - 1];
    x0 = w.x;
    y0 = w.y;
    z0 = w.z;
    if (rank == 0 && tid == 0) out[i] = idx;
  }
  // No shared-memory access crosses CTAs after the last barrier, so a CTA
  // may leave without waiting for the others.
}

// Cluster size 16 and up to 192 KB of dynamic shared memory on the current
// device, set before every launch and occupancy query.
cudaError_t set_attributes() {
  cudaError_t e =
      cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             3 * 4 * kThreads * kRegPts);
  return e;
}

cudaLaunchConfig_t launch_config(int grid, int cluster, int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_smem(int smem_bytes) {
  return smem_bytes >= 0 && smem_bytes <= 3 * 4 * kThreads * kRegPts && smem_bytes % 12 == 0;
}

}  // namespace

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory each the current device runs at once (into *out); returns the
// cudaError_t (0 on success).
extern "C" int rpcc_fps_max_active_clusters(int cluster, int smem_bytes, int* out) {
  if (cluster < 1 || cluster > kMaxCluster || !valid_smem(smem_bytes) || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, cluster, smem_bytes, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fps_cluster_kernel, &cfg));
}

// Launch FPS over B frames of n points on `stream`, one cluster of
// `cluster` CTAs per frame, `chunk` points per CTA; returns the
// cudaError_t of the launch (0 on success).  xs/ys/zs: (B, n) f32,
// num_valid: (B,) i32 device counts (masked FPS) or nullptr,
// scratch: (B, cluster, spill) f32 with spill = chunk - min(chunk, 16384),
// out: (B, k) i32.  smem_bytes = 12 * min(chunk, 16384).
extern "C" int rpcc_fps_launch(const float* xs, const float* ys, const float* zs,
                               const int32_t* num_valid,
                               int batch, int n, int k, int cluster, int chunk,
                               int smem_bytes, float* scratch, int32_t* out, void* stream) {
  static_assert(kWarps <= 32, "the second reduction stage maps warps to lanes");
  static_assert(kMaxCluster <= 32, "the cluster reduction maps ranks to lanes");
  const long long onchip = chunk < kThreads * kRegPts ? chunk : kThreads * kRegPts;
  if (batch <= 0 || n <= 0 || k <= 0 || cluster < 1 || cluster > kMaxCluster ||
      chunk != (n - 1) / cluster + 1 || smem_bytes != 12 * onchip || !valid_smem(smem_bytes) ||
      static_cast<long long>(batch) * cluster > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(batch * cluster, cluster, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  const int spill = chunk - static_cast<int>(onchip);
  e = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xs, ys, zs, num_valid, n, k, chunk, spill,
                         scratch, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
