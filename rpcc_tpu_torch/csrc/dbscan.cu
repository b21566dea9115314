// Range-image DBSCAN labels for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel rpcc_tpu/ops/dbscan_pallas.py::_dbscan_label_kernel.
// Same raw labels as that kernel and as the plain PyTorch version
// (rpcc_tpu_torch/ops/dbscan.py::dbscan_labels_planar), per (H, W) frame of
// a batch of B frames:
//   * eps-connectivity over the 48 shifts of a window-3 neighbourhood, in
//     the order of ops/dbscan.py::_neighbor_shifts (dr major, then dc, both
//     -3..3, (0, 0) left out); columns wrap at the seam, rows do not;
//   * core pixel: active and popcount(mask) + 1 >= min_points;
//   * connected components over core-core edges, each labelled by its
//     minimum flat pixel index r * W + c;
//   * a non-core active pixel takes the minimum label over its
//     eps-connected core neighbours; every other pixel gets hw.
// d2 is computed with __fsub_rn/__fmul_rn/__fadd_rn as (dx*dx + dy*dy) +
// dz*dz, so no FMA contraction moves an edge against the plain version.
// The graph is undirected by construction: (a - b)^2 == (b - a)^2 in f32,
// and a shift and its opposite map a pixel pair onto each other.
//
// What bounds it: a 64x2000 frame is 1.5 MB of coordinates plus 128 KB of
// mask in and 512 KB of labels out, all L2-resident; the TPU kernel keeps
// the same in VMEM and iterates hooks and floods until stable, with the
// graph's diameter (a 2000-pixel wall) setting the sweep count.
//
// Batches: one thread per pixel of the whole (B, H, W) batch, the frame
// from flat index / (H*W).  Neighbours are found from (r, c) within the
// frame, so the window wraps at the column seam but never reaches the next
// frame's rows.  Union-find runs on batch-global indices (frame base +
// in-frame index); every edge joins two pixels of one frame, so a root is
// its frame's base plus the component's minimum in-frame index, and labels
// are stored in-frame.
//
// Design: four launches on the caller's stream, no host loop, no sync.
//   (a) mask_kernel: one thread per pixel builds the 48-bit connectivity
//       mask (bit i = shift i), the core flag and parent[p] = p;
//   (b) union_kernel: one thread per core pixel links it with each core
//       eps-neighbour of larger flat index by lock-free union-find.  A link
//       always hangs the larger root under the smaller one with atomicCAS
//       on a root, so parent[x] <= x holds throughout: every root is its
//       tree's minimum index, and the final root is the component minimum.
//       Path halving writes only ancestors, so racing writes stay valid;
//   (c) compress_kernel: parent[p] = root(p) for every core pixel, by
//       read-only walks (only p's own thread writes parent[p]);
//   (d) label_kernel: core pixels take their root; non-core active pixels
//       the minimum root over their eps-connected core neighbours.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWindow = 3;
constexpr int kSide = 2 * kWindow + 1;
constexpr int kShifts = kSide * kSide - 1;  // 48
constexpr int kThreads = 256;

static_assert(kShifts <= 64, "the connectivity mask is one uint64 per pixel");

// Shift i -> (dr, dc) in _neighbor_shifts order (the centre is skipped).
__device__ __forceinline__ void shift_of(int i, int& dr, int& dc) {
  const int j = i < kShifts / 2 ? i : i + 1;
  dr = j / kSide - kWindow;
  dc = j % kSide - kWindow;
}

// In-frame flat index of the (r + dr, c + dc) neighbour, or -1 past the
// top or bottom row; columns wrap.
__device__ __forceinline__ int neighbour(int r, int c, int dr, int dc, int H, int W) {
  const int rr = r + dr;
  if (rr < 0 || rr >= H) return -1;
  int cc = (c + dc) % W;
  if (cc < 0) cc += W;
  return rr * W + cc;
}

// planes: (B, 3, H, W) f32; every other array is (B, H, W), indexed by the
// batch-global pixel g = frame * hw + p.
__global__ void __launch_bounds__(kThreads)
mask_kernel(const float* __restrict__ planes, const uint8_t* __restrict__ active,
            int B, int H, int W, float eps2, int min_points,
            unsigned long long* __restrict__ mask, uint8_t* __restrict__ core,
            int32_t* __restrict__ parent) {
  const int hw = H * W;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= B * hw) return;
  parent[g] = g;
  const int frame = g / hw;
  const int base = frame * hw;
  const int p = g - base;
  const float* px = planes + static_cast<size_t>(3 * frame) * hw;
  const float* py = px + hw;
  const float* pz = py + hw;
  unsigned long long bits = 0;
  if (active[g]) {
    const int r = p / W;
    const int c = p - r * W;
    const float x = px[p], y = py[p], z = pz[p];
    for (int i = 0; i < kShifts; ++i) {
      int dr, dc;
      shift_of(i, dr, dc);
      const int q = neighbour(r, c, dr, dc, H, W);
      if (q < 0 || !active[base + q]) continue;
      const float dx = __fsub_rn(x, px[q]);
      const float dy = __fsub_rn(y, py[q]);
      const float dz = __fsub_rn(z, pz[q]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < eps2) bits |= 1ull << i;
    }
  }
  mask[g] = bits;
  core[g] = (active[g] && __popcll(bits) + 1 >= min_points) ? 1 : 0;
}

// Root of x with path halving.  Reads go through volatile so a loop sees
// other threads' links; a halving write stores a grandparent, which is
// always an ancestor, so a stale write never breaks parent[x] <= x.
__device__ __forceinline__ int find_root(int32_t* parent, int x) {
  volatile int32_t* vp = parent;
  int p = vp[x];
  while (p != x) {
    const int gp = vp[p];
    if (gp != p) vp[x] = gp;
    x = p;
    p = gp;
  }
  return x;
}

__device__ __forceinline__ void unite(int32_t* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // Hang root b under the smaller root a, if b is still a root.
    if (atomicCAS(parent + b, b, a) == b) return;
  }
}

__global__ void __launch_bounds__(kThreads)
union_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ core,
             int B, int H, int W, int32_t* parent) {
  const int hw = H * W;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= B * hw || !core[g]) return;
  const int base = (g / hw) * hw;
  const int p = g - base;
  const int r = p / W;
  const int c = p - r * W;
  unsigned long long bits = mask[g];
  while (bits) {
    const int i = __ffsll(static_cast<long long>(bits)) - 1;
    bits &= bits - 1;
    int dr, dc;
    shift_of(i, dr, dc);
    const int q = neighbour(r, c, dr, dc, H, W);
    if (q > p && core[base + q]) unite(parent, g, base + q);  // each edge once, from its lower end
  }
}

// The finished forest is only read here: a halving write racing with the
// owner's final store could leave a pixel pointing at a non-root.
__global__ void __launch_bounds__(kThreads)
compress_kernel(const uint8_t* __restrict__ core, int n, int32_t* parent) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n || !core[g]) return;
  volatile int32_t* vp = parent;
  int x = g;
  int up = vp[x];
  while (up != x) {
    x = up;
    up = vp[x];
  }
  parent[g] = x;
}

// Labels are in-frame: root - frame base, or hw for unlabelled pixels.
__global__ void __launch_bounds__(kThreads)
label_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ core,
             const uint8_t* __restrict__ active, const int32_t* __restrict__ parent,
             int B, int H, int W, int32_t* __restrict__ out) {
  const int hw = H * W;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= B * hw) return;
  const int base = (g / hw) * hw;
  if (core[g]) {
    out[g] = parent[g] - base;
    return;
  }
  int best = hw;
  if (active[g]) {
    const int p = g - base;
    const int r = p / W;
    const int c = p - r * W;
    unsigned long long bits = mask[g];
    while (bits) {
      const int i = __ffsll(static_cast<long long>(bits)) - 1;
      bits &= bits - 1;
      int dr, dc;
      shift_of(i, dr, dc);
      const int q = base + neighbour(r, c, dr, dc, H, W);
      if (core[q] && parent[q] - base < best) best = parent[q] - base;
    }
  }
  out[g] = best;
}

}  // namespace

// Raw DBSCAN labels of B (H, W) frames on `stream`; returns the
// cudaError_t of the first failed launch (0 on success).
// planes: (B, 3, H, W) f32; active: (B, H, W) u8; scratch: mask (B*H*W)
// u64, parent (B*H*W) i32, core (B*H*W) u8; out: (B, H, W) i32 in-frame
// labels.
extern "C" int rpcc_dbscan_labels_launch(const float* planes, const uint8_t* active, int B,
                                         int H, int W, float eps2, int min_points,
                                         unsigned long long* mask, int32_t* parent,
                                         uint8_t* core, int32_t* out, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n = B * H * W;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mask_kernel<<<blocks, kThreads, 0, s>>>(planes, active, B, H, W, eps2, min_points, mask, core,
                                          parent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  union_kernel<<<blocks, kThreads, 0, s>>>(mask, core, B, H, W, parent);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compress_kernel<<<blocks, kThreads, 0, s>>>(core, n, parent);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  label_kernel<<<blocks, kThreads, 0, s>>>(mask, core, active, parent, B, H, W, out);
  return static_cast<int>(cudaGetLastError());
}
