// Range-image DBSCAN labels for Hopper (sm_90a), plain C ABI: two launches
// per batch, a grid-wide mask pass and then one thread-block cluster per
// frame.
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
// What bounds it: a 64x2000 frame is 1.5 MB of coordinates and 128 KB of
// mask in and 512 KB of labels out, 0.65 us at 3.35 TB/s; the 48 shifts of
// each active pixel are less work than that.  The time is latency: chains
// of dependent shared-memory loads in the union-find and the cluster
// barriers between phases.  The TPU kernel keeps the frame in VMEM and
// iterates hooks and floods until stable.
//
// Launch 1, the mask pass (dbscan_mask_kernel), spreads the 48 distance
// tests of every pixel over the whole card: a block stages a 22x70 tile of
// x/y/z/active (16 rows by 64 columns and a 3-pixel halo, columns wrapped)
// in shared memory, and each thread walks 4 pixels of one column, so that a
// loaded neighbour serves every pixel whose window holds it.  It writes each
// pixel's u64 mask word (the 48-bit connectivity mask, bit i = shift i, the
// core flag in bit 62, the active flag in bit 63; 0 when inactive) to device
// memory.  Done inside the cluster kernel, on the C SMs of one frame, the
// same pass took about half of a frame's time (PERF.md).
//
// Launch 2 (dbscan_cluster_kernel): grid (C, B), clusters of C CTAs along
// x, so cluster b is frame b.  CTA r owns the band of columns
// [r * band, min((r + 1) * band, W)) over all H rows, band = ceil(W / C).
// Bands follow columns: the window reaches 3 rows of a 64-row frame, but
// only 6 halo columns of a 125-column band.  A band may be narrower than the
// window and trailing bands may be empty, so a neighbour's owner is computed
// (column / band), never assumed to be the CTA next door; the seam makes
// band C-1 a neighbour of band 0.  Owned pixel (r, c) has slot
// r * band + (c - r's band start) in its CTA, which keeps its u64 mask word
// and one i32 parent: 12 B a pixel in shared memory, 96 KB at C = 16 and
// 192 KB at C = 8 on the 64E grid.  Slots from `onchip` on stay in device
// memory instead (the mask word where launch 1 wrote it, the parent in a
// scratch), in the same kernel and through the same accessors.  Phases:
//   1. the owned pixels' mask words into shared memory;
//   2. (block barrier) union-find over the band's own core-core edges, in
//      slot indices in the CTA's shared memory; then every core pixel's
//      parent becomes its band root as a flat index, and every other
//      pixel's parent -1;
//   3. (cluster barrier: every CTA has started and its forest is visible)
//      union over the core-core edges between bands, in flat indices,
//      through distributed shared memory (DSMEM);
//   4. (cluster barrier) parent = root for every owned core pixel, by
//      read-only walks that may cross CTAs;
//   5. (cluster barrier) labels, written in-frame to device memory;
//   6. a last cluster barrier: no CTA leaves while another may still read
//      its shared memory.
// Union-find: a link always hangs the larger root under the smaller one
// with atomicCAS on a root, so parent[x] <= x holds throughout: every root
// is its tree's minimum index, and the final root is the component minimum.
// Path halving writes only ancestors, so racing writes stay valid.  Each
// edge is linked once, from its lower end, or left to an earlier pixel
// whose own edges imply it (own_edges).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWindow = 3;
constexpr int kSide = 2 * kWindow + 1;
constexpr int kShifts = kSide * kSide - 1;  // 48
constexpr int kCentre = kShifts / 2;        // the centre's window position
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kBytesPerPixel = 12;  // u64 mask word + i32 parent
// The mask pass: a block of kMaskThreads stages a tile of kTileRows x
// kTileCols pixels and its halo; a thread takes kRowsPerThread pixels of
// one column.
constexpr int kMaskThreads = 256;
constexpr int kTileCols = 64;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kMaskThreads / kTileCols * kRowsPerThread;  // 16
constexpr int kHaloRows = kTileRows + 2 * kWindow;
constexpr int kHaloCols = kTileCols + 2 * kWindow;

constexpr unsigned long long kEdgeBits = (1ull << kShifts) - 1;
constexpr unsigned long long kCoreBit = 1ull << 62;
constexpr unsigned long long kActiveBit = 1ull << 63;
constexpr int kLeft = kCentre - 1;  // bit of shift (0, -1)
constexpr int kUp = kCentre - kSide;  // bit of shift (-1, 0)
// Shifts to a later pixel of the frame: dr > 0, or dr == 0 and dc > 0.
constexpr unsigned long long kForwardBits = kEdgeBits & ~((1ull << kCentre) - 1);
static_assert(kShifts <= 62, "the connectivity mask shares one uint64 with the two flags");

// Window masks: bit a * kSide + k for the shift (a - kWindow, k - kWindow),
// the centre's bit always 0.  Below the centre a window bit and a mask bit
// coincide; above it the mask bit is one lower.
constexpr unsigned long long kLowBits = (1ull << kCentre) - 1;
constexpr unsigned long long kLastCol = 0x40810204081ull << (kSide - 1);  // k == kSide - 1
static_assert(kLastCol == (1ull << 6 | 1ull << 13 | 1ull << 20 | 1ull << 27 | 1ull << 34 |
                           1ull << 41 | 1ull << 48),
              "one bit in each window row");

__device__ __forceinline__ unsigned long long to_window(unsigned long long bits) {
  return (bits & kLowBits) | ((bits & kEdgeBits & ~kLowBits) << 1);
}
__device__ __forceinline__ unsigned long long from_window(unsigned long long win) {
  return (win & kLowBits) | ((win >> (kCentre + 1)) << kCentre);
}

// Shift i -> (dr, dc) in _neighbor_shifts order (the centre is skipped).
__device__ __forceinline__ void shift_of(int i, int& dr, int& dc) {
  const int j = i < kCentre ? i : i + 1;
  dr = j / kSide - kWindow;
  dc = j % kSide - kWindow;
}

// Column c wrapped into [0, W) (c may lie several widths out when W < 7).
__device__ __forceinline__ int wrap(int c, int W) {
  while (c < 0) c += W;
  while (c >= W) c -= W;
  return c;
}

// n / d for 0 <= n < 2^31 by one multiply-high and a shift, d fixed for the
// launch (Granlund-Montgomery, as CUTLASS's FastDivmod).
struct FastDiv {
  unsigned d, m;
  int s;
  __device__ explicit FastDiv(int divisor) : d(divisor), m(0), s(0) {
    if (divisor == 1) return;
    const int p = 31 + 32 - __clz(divisor - 1);  // 31 + ceil(log2(divisor))
    m = static_cast<unsigned>(((1ull << p) + divisor - 1) / divisor);
    s = p - 32;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), m) >> s);
  }
};

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return t;
}

// The forest is read and written by many threads, of many CTAs in phase 3,
// while unions run: its accesses go through volatile (or atomic) ops.
template <class T>
__device__ __forceinline__ T load(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}

template <class T>
__device__ __forceinline__ void store(T* p, T v) {
  *reinterpret_cast<volatile T*>(p) = v;
}

// A CTA's own parents: shared memory below `onchip`, the CTA's part of the
// scratch above.
struct OwnParents {
  int32_t* s;
  int32_t* g;
  int onchip;
  __device__ __forceinline__ int ld(int l) const {
    return l < onchip ? load(s + l) : load(g + (l - onchip));
  }
  __device__ __forceinline__ void st(int l, int v) const {
    if (l < onchip)
      store(s + l, v);
    else
      store(g + (l - onchip), v);
  }
  __device__ __forceinline__ int cas(int l, int cmp, int v) const {
    return l < onchip ? atomicCAS(s + l, cmp, v) : atomicCAS(g + (l - onchip), cmp, v);
  }
};

// A CTA's own mask words, read-only after phase 1: shared memory below
// `onchip`, the frame's mask from launch 1 above (slot l of row r is pixel
// (r, c0 + l - r * band)).
struct OwnMasks {
  const unsigned long long* s;
  const unsigned long long* g;
  int onchip, band, W, c0;
  FastDiv by_band;
  __device__ __forceinline__ unsigned long long ld(int l) const {
    if (l < onchip) return s[l];
    const int r = by_band(l);
    return g[r * W + c0 + (l - r * band)];
  }
};

// The frame's forest over in-frame flat indices, as seen from one CTA of its
// cluster: a pixel's parent lives in its owner CTA's shared memory (through
// DSMEM) or, past `onchip`, in that CTA's part of the scratch.
struct FrameForest {
  int32_t* s_parent;  // this CTA's parent[onchip]
  int32_t* g_parent;  // this frame's scratch: (C, spill)
  int W, band, onchip, spill, rank;
  FastDiv by_w, by_band;

  // Owner CTA (x) and slot (y) of in-frame pixel (r, c).
  __device__ __forceinline__ int2 slot(int r, int c) const {
    const int o = by_band(c);
    return make_int2(o, r * band + (c - o * band));
  }
  __device__ __forceinline__ int32_t* parent(int2 s) const {
    if (s.y >= onchip) return g_parent + static_cast<size_t>(s.x) * spill + (s.y - onchip);
    return s.x == rank ? s_parent + s.y : cg::this_cluster().map_shared_rank(s_parent + s.y, s.x);
  }
  __device__ __forceinline__ int32_t* parent(int q) const {
    const int r = by_w(q);
    return parent(slot(r, q - r * W));
  }
  __device__ __forceinline__ int ld(int q) const { return load(parent(q)); }
  __device__ __forceinline__ void st(int q, int v) const { store(parent(q), v); }
  __device__ __forceinline__ int cas(int q, int cmp, int v) const {
    return atomicCAS(parent(q), cmp, v);
  }
};

// Root of x with path halving, in a forest with ld / st / cas on parents.
template <class Forest>
__device__ int find_root(const Forest& f, int x) {
  int p = f.ld(x);
  while (p != x) {
    const int gp = f.ld(p);
    if (gp != p) f.st(x, gp);  // gp is an ancestor of x: a stale write stays valid
    x = p;
    p = gp;
  }
  return x;
}

template <class Forest>
__device__ void unite(const Forest& f, int a, int b) {
  while (true) {
    a = find_root(f, a);
    b = find_root(f, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // Hang root b under the smaller root a, if b is still a root.
    if (f.cas(b, b, a) == b) return;
  }
}

// Root of x by a read-only walk.
template <class Forest>
__device__ int walk(const Forest& f, int x) {
  int up = f.ld(x);
  while (up != x) {
    x = up;
    up = f.ld(x);
  }
  return x;
}

// Launch 1: the mask word of every pixel of B (H, W) frames.  Grid
// (ceil(W / kTileCols), ceil(H / kTileRows), B), kMaskThreads threads.  A
// neighbour row outside the frame is staged inactive (rows do not wrap);
// columns wrap.  planes: (B, 3, H, W); active: (B, H, W) bool; masks:
// (B, H, W) u64; stamps: null, or frame 0's first block writes stamps[0].
__global__ void __launch_bounds__(kMaskThreads)
dbscan_mask_kernel(const float* __restrict__ planes, const uint8_t* __restrict__ active, int H,
                   int W, float eps2, int min_points, unsigned long long* __restrict__ masks,
                   unsigned long long* __restrict__ stamps) {
  __shared__ float4 tile[kHaloRows][kHaloCols];  // x, y, z, and 1 / 0 for active
  const int frame = blockIdx.z;
  const int hw = H * W;
  if (stamps != nullptr && frame == 0 && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    stamps[0] = global_timer();
  const float* px = planes + static_cast<size_t>(3 * frame) * hw;
  const float* py = px + hw;
  const float* pz = py + hw;
  const uint8_t* act = active + static_cast<size_t>(frame) * hw;
  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * kTileCols;
  for (int i = threadIdx.x; i < kHaloRows * kHaloCols; i += kMaskThreads) {
    const int a = i / kHaloCols;
    const int k = i - a * kHaloCols;
    const int r = r0 + a - kWindow;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= 0 && r < H) {
      const int q = r * W + wrap(c0 + k - kWindow, W);
      v = make_float4(px[q], py[q], pz[q], act[q] ? 1.f : 0.f);
    }
    tile[a][k] = v;
  }
  __syncthreads();
  const int tc = threadIdx.x % kTileCols;
  const int tr = threadIdx.x / kTileCols * kRowsPerThread;
  const int c = c0 + tc;
  if (c >= W) return;
  float4 me[kRowsPerThread];
  unsigned long long win[kRowsPerThread];  // bit a * kSide + k: window position (a, k)
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    me[j] = tile[tr + j + kWindow][tc + kWindow];
    win[j] = 0;
  }
  // Tile row tr + a is window row a - j of the thread's pixel j.
#pragma unroll
  for (int a = 0; a < kRowsPerThread + 2 * kWindow; ++a) {
#pragma unroll
    for (int k = 0; k < kSide; ++k) {
      const float4 q = tile[tr + a][tc + k];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int d = a - j;
        if (d < 0 || d >= kSide || (d == kWindow && k == kWindow)) continue;
        const float dx = __fsub_rn(me[j].x, q.x);
        const float dy = __fsub_rn(me[j].y, q.y);
        const float dz = __fsub_rn(me[j].z, q.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        win[j] |= static_cast<unsigned long long>((d2 < eps2) & (q.w != 0.f)) << (d * kSide + k);
      }
    }
  }
  unsigned long long* out = masks + static_cast<size_t>(frame) * hw;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + tr + j;
    if (r >= H) break;
    unsigned long long bits = 0;
    if (me[j].w != 0.f) {
      bits = from_window(win[j]) | kActiveBit;
      if (__popcll(bits & kEdgeBits) + 1 >= min_points) bits |= kCoreBit;
    }
    out[r * W + c] = bits;
  }
}

// Candidate edges of core pixel l at (r, cl): the bits of `bits` within
// `scan`, without those that its left or upper neighbour also has when that
// neighbour is a core pixel linked to l.  An edge (l, q) that the left pixel
// l-1 also has (to the same q, at dc + 1) follows from (l-1, q) and the link
// (l-1, l); one that the upper pixel has (at dr + 1) from (l - band, q) and
// the link.  Both lie at an earlier slot and flat index, which keeps the
// edge unless an earlier pixel has it in turn, so every component keeps a
// spanning set of its edges.
template <class Masks>
__device__ __forceinline__ unsigned long long own_edges(const Masks& masks, int l, int r, int cl,
                                                        int band, unsigned long long bits,
                                                        unsigned long long scan) {
  unsigned long long cand = to_window(bits & scan);
  if (cl > 0 && ((bits >> kLeft) & 1ull)) {
    const unsigned long long left = masks.ld(l - 1);
    if (left & kCoreBit) cand &= ~((to_window(left) >> 1) & ~kLastCol);
  }
  if (r > 0 && ((bits >> kUp) & 1ull)) {
    const unsigned long long up = masks.ld(l - band);
    if (up & kCoreBit) cand &= ~(to_window(up) >> kSide);  // nothing lands on dr == kWindow
  }
  return from_window(cand);
}

// Launch 2.  mask: (B, H, W) u64 mask words from launch 1; out: (B, H, W)
// i32 in-frame labels; scratch_parent: (B, C, spill) i32 (null when spill
// is 0); stamps: 7 u64, or null.
__global__ void __launch_bounds__(kThreads, 1)
dbscan_cluster_kernel(const unsigned long long* __restrict__ mask, int H, int W, int band,
                      int onchip, int spill, int32_t* scratch_parent, int32_t* __restrict__ out,
                      unsigned long long* __restrict__ stamps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int frame = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool timed = stamps != nullptr && frame == 0 && rank == 0 && tid == 0;
  if (timed) stamps[1] = global_timer();

  const int hw = H * W;
  mask += static_cast<size_t>(frame) * hw;
  out += static_cast<size_t>(frame) * hw;

  extern __shared__ unsigned long long s_mem[];
  int32_t* s_parent = reinterpret_cast<int32_t*>(s_mem + onchip);
  const size_t frame_spill = static_cast<size_t>(frame) * C * spill;
  const size_t own_spill = frame_spill + static_cast<size_t>(rank) * spill;
  const FastDiv by_band(band);
  const int c0 = rank * band;
  const int width = max(0, min(band, W - c0));
  const int n_slots = H * band;
  const OwnMasks masks{s_mem, mask, onchip, band, W, c0, by_band};
  const OwnParents parents{s_parent, scratch_parent + own_spill, onchip};
  const FrameForest forest{s_parent, scratch_parent + frame_spill, W, band, onchip, spill, rank,
                           FastDiv(W), by_band};

  // 1. The owned pixels' mask words into shared memory.
  for (int l = tid; l < onchip; l += kThreads) {
    const int r = by_band(l);
    const int cl = l - r * band;
    s_mem[l] = cl < width ? mask[r * W + c0 + cl] : 0ull;
  }
  __syncthreads();
  if (timed) stamps[2] = global_timer();

  // 2. Band-local unions, in slot indices: within a band, slot order is flat
  //    order (both row-major), so the minimum slot is the minimum pixel.
  //    First the runs along each row: a warp takes a row, 32 columns at a
  //    time, and points every core pixel at the first pixel of its run of
  //    (0, 1)-linked core pixels, so trees start one level deep; every
  //    other pixel is its own root.
  for (int r = tid >> 5; r < H; r += kWarps) {
    int carry = 0;  // the run start of the previous 32 columns' last lane
    bool carry_core = false;
    for (int base = 0; base < width; base += 32) {
      const int cl = base + lane;
      const int l = r * band + cl;
      const unsigned long long bits = cl < width ? masks.ld(l) : 0ull;
      const bool core = bits & kCoreBit;
      const unsigned core_lanes = __ballot_sync(0xffffffffu, core);
      const bool left_core = lane > 0 ? (core_lanes >> (lane - 1)) & 1u : carry_core;
      const bool linked = core && cl > 0 && left_core && ((bits >> kLeft) & 1ull);
      const unsigned upto = __ballot_sync(0xffffffffu, !linked) & (0xffffffffu >> (31 - lane));
      const int start = upto ? r * band + base + 31 - __clz(upto) : carry;
      if (cl < width) parents.st(l, core ? start : l);
      carry = __shfl_sync(0xffffffffu, start, 31);
      carry_core = core_lanes >> 31;
    }
  }
  __syncthreads();
  // Then every other edge with both ends here, once, from its lower end:
  // where no column wraps into its own band (W >= width + kWindow) the
  // forward shifts, else every shift with a later slot.  Edges that a linked
  // left or upper pixel also has are left to it, and a neighbour whose
  // parent is the one last united is skipped.
  const unsigned long long scan = W >= width + kWindow ? kForwardBits : kEdgeBits;
  for (int l = tid; l < n_slots; l += kThreads) {
    const int r = by_band(l);
    const int cl = l - r * band;
    if (cl >= width) continue;
    const unsigned long long bits = masks.ld(l);
    if (!(bits & kCoreBit)) continue;
    unsigned long long e = own_edges(masks, l, r, cl, band, bits, scan);
    int done = parents.ld(l);  // a member of l's tree
    while (e) {
      const int i = __ffsll(static_cast<long long>(e)) - 1;
      e &= e - 1;
      int dr, dc;
      shift_of(i, dr, dc);
      const int cq = wrap(c0 + cl + dc, W) - c0;
      if (cq < 0 || cq >= width) continue;  // another band's pixel: phase 3
      const int lq = (r + dr) * band + cq;
      if (lq <= l || !(masks.ld(lq) & kCoreBit)) continue;
      const int up = parents.ld(lq);  // an ancestor of lq: uniting it unites lq
      if (up == done) continue;
      unite(parents, done, up);
      done = up;
    }
  }
  __syncthreads();
  // Every owned core pixel's parent becomes its band root (read-only walks;
  // only l's thread writes parent[l], always an ancestor) ...
  for (int l = tid; l < n_slots; l += kThreads) {
    if (l - by_band(l) * band < width && (masks.ld(l) & kCoreBit)) parents.st(l, walk(parents, l));
  }
  __syncthreads();
  // ... then that root's flat index; a pixel that is not core gets -1, so
  // that one read of a neighbour's parent says whether it is core.
  for (int l = tid; l < n_slots; l += kThreads) {
    if (l - by_band(l) * band >= width) continue;
    if (!(masks.ld(l) & kCoreBit)) {
      parents.st(l, -1);
      continue;
    }
    const int root = parents.ld(l);
    const int rr = by_band(root);
    parents.st(l, rr * W + c0 + (root - rr * band));
  }
  cluster.sync();
  if (timed) stamps[3] = global_timer();

  // 3. Cross-band unions, in flat indices: only a pixel within kWindow
  //    columns of its band's edges can have a neighbour in another band;
  //    one thread per such pixel, with the reductions of phase 2.
  const int edge_cols = min(width, 2 * kWindow);
  for (int t = tid; t < H * edge_cols; t += kThreads) {
    const int r = t / edge_cols;
    const int x = t - r * edge_cols;
    const int cl = x < kWindow || edge_cols < 2 * kWindow ? x : width - 2 * kWindow + x;
    const int l = r * band + cl;
    const unsigned long long bits = masks.ld(l);
    if (!(bits & kCoreBit)) continue;
    const int c = c0 + cl;
    const int p = r * W + c;
    unsigned long long e = own_edges(masks, l, r, cl, band, bits, kEdgeBits);
    int done = parents.ld(l);  // the pixel's band root
    while (e) {
      const int i = __ffsll(static_cast<long long>(e)) - 1;
      e &= e - 1;
      int dr, dc;
      shift_of(i, dr, dc);
      const int rr = r + dr;
      const int cc = wrap(c + dc, W);
      // A pixel of another band, this being the edge's lower end.
      if (static_cast<unsigned>(cc - c0) < static_cast<unsigned>(width) || rr * W + cc < p)
        continue;
      const int up = load(forest.parent(forest.slot(rr, cc)));  // -1 unless core
      if (up < 0 || up == done) continue;
      unite(forest, done, up);
      done = up;
    }
  }
  cluster.sync();
  if (timed) stamps[4] = global_timer();

  // 4. Resolve: parent = root for every owned core pixel.
  for (int l = tid; l < n_slots; l += kThreads) {
    if (l - by_band(l) * band < width && (masks.ld(l) & kCoreBit))
      parents.st(l, walk(forest, parents.ld(l)));
  }
  cluster.sync();
  if (timed) stamps[5] = global_timer();

  // 5. Labels.
  for (int l = tid; l < n_slots; l += kThreads) {
    const int r = by_band(l);
    const int cl = l - r * band;
    if (cl >= width) continue;
    const int c = c0 + cl;
    const unsigned long long bits = masks.ld(l);
    int label = hw;
    if (bits & kCoreBit) {
      label = parents.ld(l);
    } else if (bits & kActiveBit) {
      unsigned long long e = bits & kEdgeBits;
      while (e) {
        const int i = __ffsll(static_cast<long long>(e)) - 1;
        e &= e - 1;
        int dr, dc;
        shift_of(i, dr, dc);
        const int up = load(forest.parent(forest.slot(r + dr, wrap(c + dc, W))));
        if (up >= 0) label = min(label, up);  // a core neighbour's root
      }
    }
    out[r * W + c] = label;
  }
  // 6. Other CTAs may still be reading this CTA's shared memory.
  cluster.sync();
  if (timed) stamps[6] = global_timer();
}

// Cluster sizes up to 16 and the device's opt-in shared memory per CTA
// (into *smem_limit), set before every launch and occupancy query.  The
// cluster kernel has no static shared memory, so all of it is dynamic.
cudaError_t set_attributes(int* smem_limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dbscan_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dbscan_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem_limit);
  return e;
}

cudaLaunchConfig_t launch_config(int cluster, int batch, int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
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

}  // namespace

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory each the current device runs at once (into *out); returns the
// cudaError_t (0 on success).
extern "C" int rpcc_dbscan_max_active_clusters(int cluster, int smem_bytes, int* out) {
  if (cluster < 1 || cluster > kMaxCluster || smem_bytes < 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem_limit = 0;
  cudaError_t e = set_attributes(&smem_limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes > smem_limit) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, 1, smem_bytes, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, dbscan_cluster_kernel, &cfg));
}

// Raw DBSCAN labels of B (H, W) frames on `stream`: the mask pass, then one
// cluster of `cluster` CTAs per frame; returns the first failing launch's
// cudaError_t (0 on success).  The plan is ops/dbscan.py::plan_for's: bands
// of `band` columns (band * cluster >= W), `onchip` of a CTA's H * band
// slots in `smem_bytes` (>= 12 * onchip) of shared memory, the other
// spill = H * band - onchip slots' parents in scratch_parent ((B, cluster,
// spill); may be null when spill is 0).  planes: (B, 3, H, W) f32; active:
// (B, H, W) bool; mask: (B, H, W) u64 for launch 1's output; out: (B, H, W)
// i32.  stamps: null, or 7 u64 that frame 0 fills with %globaltimer (ns) at
// the start of launch 1, the start of launch 2 and after each of launch 2's
// five phases (ops/dbscan.py::PHASES).
extern "C" int rpcc_dbscan_labels_launch(const float* planes, const uint8_t* active, int B,
                                         int H, int W, float eps2, int min_points, int cluster,
                                         int band, int onchip, int smem_bytes,
                                         unsigned long long* mask, int32_t* scratch_parent,
                                         int32_t* out, unsigned long long* stamps, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || static_cast<long long>(H) * W > INT_MAX ||
      (H - 1) / kTileRows >= 65535 || cluster < 1 || cluster > kMaxCluster || band < 1 ||
      static_cast<long long>(band) * cluster < W || static_cast<long long>(H) * band > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int spill = H * band - onchip;
  if (onchip < 0 || spill < 0 || smem_bytes < static_cast<long long>(kBytesPerPixel) * onchip ||
      mask == nullptr || (spill > 0 && scratch_parent == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int smem_limit = 0;
  cudaError_t e = set_attributes(&smem_limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes > smem_limit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tiles((W - 1) / kTileCols + 1, (H - 1) / kTileRows + 1, B);
  dbscan_mask_kernel<<<tiles, kMaskThreads, 0, s>>>(planes, active, H, W, eps2, min_points, mask,
                                                    stamps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, B, smem_bytes, s, &attr);
  e = cudaLaunchKernelEx(&cfg, dbscan_cluster_kernel, static_cast<const unsigned long long*>(mask),
                         H, W, band, onchip, spill, scratch_parent, out, stamps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
