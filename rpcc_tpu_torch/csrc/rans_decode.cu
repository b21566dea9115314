// rANS decode of the residual stream and the contour plane on Hopper (sm_90a).
//
// Replaces the XLA program of rpcc_tpu/ops/rans.py's decoders: rans_decode_ctx
// (through decode_streams_batch_ctx: zigzag contexts for the residual 'C'
// container, wavefront contexts for the contour 'N' container, a zero context
// for the order-0 'D' container), which the reference's codec runs on its
// device under RPCC_RANS_DEVICE=default (rpcc_tpu/codec/rans_codec.py:350-356,
// 776-791).  That was no Pallas kernel, but its lax.scan of T dependent steps
// is ~15 launches a step in eager PyTorch, ~60,000 a batch, so the port needs
// one kernel.  Semantics, and the plain PyTorch version every output equals:
// rpcc_tpu_torch/ops/rans.py (decode_streams_batch_ctx); the wrapper:
// rpcc_tpu_torch/ops/rans_device.py (decode_streams_cuda).
//
// What bounds it: not bytes (a 64x2000 frame's words, tables and symbols are
// ~1.6 MB, ~0.5 us at 3.35 TB/s) but the chain of dependent steps of each
// lane: T_max steps (4000 for the 64E residual, 2064 for its contour), each
// a table lookup that depends on the state the step before made.  Nothing can
// run a lane's steps in parallel, so a step is kept short and the rest of the
// work stays off the walking threads' chain.
//
// Design: one launch decodes a batch of one field (mode 0: zigzag contexts,
// mode 2: order-0, mode 1: wavefront), one block per frame.
//  * Modes 0 and 2 (rans_decode_lanes_kernel): up to 32 independent lanes,
//    one warp.  The block's 8 warps first build the frame's tables in shared
//    memory: each context's exclusive cumulative sums (a warp scan) beside
//    its frequencies, one 8-byte {f, c} record per (context, symbol), and
//    the slot -> symbol table, u16 per slot (4 contexts x 16,384 slots =
//    128 KB, the opt-in dynamic shared memory): each warp fills a range of
//    slots 32 at a time, a lane advancing its own symbol cursor over the
//    inclusive sums (one binary search to start), so the table costs about a
//    slot a lane-step.  The table keeps a step at two dependent shared loads
//    (slot -> symbol, symbol -> {f, c}); a binary search over the 513 sums
//    of a context instead would put ~9 dependent loads on every step.  Then
//    warp 0 walks, a thread per lane.  A lane's next word is prefetched in a
//    register (one load each time a word is taken), so a renormalization
//    does not wait on memory unless two come in consecutive steps.
//  * Mode 1 (rans_decode_wavefront_kernel): H <= 512 lanes, a thread each,
//    in lockstep: the context 2 * above + left needs lane r-1's symbol of the
//    step before, a shuffle within a warp and, across warps, a double-buffered
//    shared slot and one barrier a step (none for H <= 32).  A symbol is
//    slot >= freq[ctx][0]; both candidate {f, c} pairs of the context come in
//    one 16-byte shared load, so the state's chain has no table load.
//  * Symbols go through a per-warp tile in shared memory and leave 32 steps
//    at a time, a row's 32 steps in one coalesced store.
//
// The tables follow the spec for any u16 frequencies (the wire's type; the
// kernel reads each int32 frequency's low 16 bits): slot j holds the first
// symbol whose inclusive sum exceeds j, else the last symbol, as
// jnp.repeat(..., total_repeat_length=M) pads.  A word index is clamped into
// [0, T - 1], as the reference's gather clamps it: a corrupt container decodes
// to the spec's symbols and nothing reads out of bounds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kProbBits = 14;
constexpr uint32_t kM = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxLanes = 32;    // a residual field: one warp
constexpr int kMaxRows = 512;    // contour lanes: a thread each
constexpr int kMaxAlphabet = 512;
constexpr int kMaxCtx = 4;
constexpr int kLanesThreads = 256;  // modes 0 and 2: 8 warps build the tables, warp 0 walks
constexpr int kTile = 32;           // steps per coalesced flush of the symbols
constexpr int kLanesSmemMax = kMaxCtx * kMaxAlphabet * 8 + kMaxCtx * (int)kM * 2;

enum Mode { kZigzag = 0, kWavefront = 1, kOrder0 = 2 };

struct Params {
  const uint16_t* words;  // (B, L, T) u16, lane l's first counts[l] words
  const int32_t* counts;  // (B, L)
  const int64_t* states;  // (B, L), the u32 final encoder states
  const int32_t* lives;   // (B, L) live steps per lane
  const int32_t* freqs;   // (B, C, A), read as u16
  int32_t* out;           // (B, L, T) symbols
  int L, T, C, A;
};

// A lane's walk state: its u32 state, word cursor and the prefetched word
// words[clamp(cur - 1)], the next one a renormalization takes.
struct Lane {
  const uint16_t* w;
  uint32_t x;
  uint32_t next;
  int cur;
  int live;
};

__device__ __forceinline__ uint32_t word_at(const uint16_t* w, int i, int T) {
  return w[min(max(i, 0), T - 1)];
}

__device__ __forceinline__ Lane lane_init(const Params& p, int b, int l, bool mine) {
  Lane s{nullptr, 0u, 0u, 0, 0};
  if (mine) {
    const size_t row = (size_t)b * p.L + l;
    s.w = p.words + row * p.T;
    s.x = (uint32_t)p.states[row];
    s.cur = p.counts[row];
    s.live = min(max(p.lives[row], 0), p.T);
    s.next = word_at(s.w, s.cur - 1, p.T);
  }
  return s;
}

// One step's state update from the symbol's {f, c}: x' = f * (x >> 14) +
// slot - c, then a word read back in when x' fell below 2^16 (u32 wrap, as
// the spec's arithmetic).
__device__ __forceinline__ void lane_update(Lane& s, uint32_t slot, uint32_t f, uint32_t c, int T) {
  uint32_t x = f * (s.x >> kProbBits) + slot - c;
  if (x < kRansL) {
    --s.cur;
    x = (x << 16) | s.next;
    s.next = word_at(s.w, s.cur - 1, T);
  }
  s.x = x;
}

__device__ __forceinline__ int zigzag_ctx(int prev) {
  const int mag = (prev + 1) >> 1;  // |delta| of the previous zigzag symbol
  return (mag >= 1) + (mag >= 3) + (mag >= 8);
}

template <int kMode>
__global__ void __launch_bounds__(kLanesThreads) rans_decode_lanes_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint16_t tile[kMaxLanes][kTile + 2];  // a row's stride of 17 words spreads the banks
  const int C = p.C, A = p.A, T = p.T, L = p.L;
  uint2* fc = reinterpret_cast<uint2*>(smem);                                  // (C, A) {f, c}
  uint16_t* s2s = reinterpret_cast<uint16_t*>(smem + (size_t)C * A * sizeof(uint2));  // (C, M)
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // 1. {f, exclusive cum} per (context, symbol): a warp per context, a lane
  //    per run of ceil(A / 32) symbols.
  const int32_t* fq = p.freqs + (size_t)b * C * A;
  const int per = (A + 31) / 32;
  for (int c = warp; c < C; c += nwarps) {
    const int lo = min(lane * per, A), hi = min(lo + per, A);
    uint32_t sum = 0;
    for (int a = lo; a < hi; ++a) sum += (uint16_t)fq[c * A + a];
    uint32_t incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    uint32_t run = incl - sum;
    for (int a = lo; a < hi; ++a) {
      const uint32_t f = (uint16_t)fq[c * A + a];
      fc[c * A + a] = make_uint2(f, run);
      run += f;
    }
  }
  __syncthreads();

  // 2. slot -> symbol: a warp per range of slots, 32 consecutive slots a
  //    round; each lane's cursor u = #{a : inclusive sum of a <= slot}
  //    only grows along its slots.
  {
    const int total = C * (int)kM;
    const int span = (total / 32 + nwarps - 1) / nwarps * 32;
    const int g1 = min((warp + 1) * span, total);
    int u = 0, row_ctx = -1;
    for (int g = warp * span + lane; g < g1; g += 32) {
      const int c = g >> kProbBits;
      const uint32_t j = (uint32_t)g & (kM - 1);
      const uint2* row = fc + c * A;
      if (c != row_ctx) {
        int lo = 0, hi = A;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (row[mid].x + row[mid].y <= j) lo = mid + 1; else hi = mid;
        }
        u = lo;
        row_ctx = c;
      } else {
        while (u < A && row[u].x + row[u].y <= j) ++u;
      }
      s2s[g] = (uint16_t)min(u, A - 1);
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 3. the walk: thread l decodes lane l, T steps.
  Lane s = lane_init(p, b, lane, lane < L);
  int prev = 0;
  for (int t0 = 0; t0 < T; t0 += kTile) {
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      int sym = 0;
      if (t0 + k < s.live) {
        const int ctx = kMode == kZigzag ? zigzag_ctx(prev) : 0;  // 0 at t == 0: prev is 0
        const uint32_t slot = s.x & (kM - 1);
        sym = s2s[ctx * kM + slot];
        const uint2 e = fc[ctx * A + sym];
        lane_update(s, slot, e.x, e.y, T);
      }
      prev = sym;
      tile[lane][k] = (uint16_t)sym;
    }
    __syncwarp();
    const int t = t0 + lane;
    if (t < T) {
      int32_t* o = p.out + (size_t)b * L * T + t;
      for (int r = 0; r < L; ++r) o[(size_t)r * T] = tile[r][lane];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kMaxRows) rans_decode_wavefront_kernel(Params p) {
  __shared__ uint4 tab[kMaxCtx];              // per context {f0, c0 = 0, f1, c1 = f0}
  __shared__ int edge[2][kMaxRows / 32];      // each warp's last lane's symbol, by step parity
  __shared__ uint8_t tile[kMaxRows / 32][32][kTile + 4];  // a row's stride of 9 words spreads the banks
  const int b = blockIdx.x, r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const int nwarps = blockDim.x >> 5;
  const int H = p.L, T = p.T;
  if (r < kMaxCtx) {
    const int32_t* fq = p.freqs + ((size_t)b * kMaxCtx + r) * 2;
    const uint32_t f0 = (uint16_t)fq[0], f1 = (uint16_t)fq[1];
    tab[r] = make_uint4(f0, 0u, f1, f0);
  }
  __syncthreads();

  Lane s = lane_init(p, b, r, r < H);
  int left = 0, above = 0;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    for (int k = 0; k < kTile; ++k) {
      const int t = t0 + k;
      int sym = 0;
      if (t < s.live) {
        const uint4 e = tab[2 * above + left];  // context 0 at t == 0: both are 0
        const uint32_t slot = s.x & (kM - 1);
        sym = slot >= e.x;
        lane_update(s, slot, sym ? e.z : e.x, sym ? e.w : e.y, T);
      }
      left = sym;
      tile[warp][lane][k] = (uint8_t)sym;
      // above for step t + 1: lane r - 1's symbol at t (0 for lane 0)
      int up = __shfl_up_sync(0xffffffffu, sym, 1);
      if (nwarps > 1) {
        if (lane == 31) edge[t & 1][warp] = sym;
        __syncthreads();
        if (lane == 0) up = warp > 0 ? edge[t & 1][warp - 1] : 0;
      } else if (lane == 0) {
        up = 0;
      }
      above = up;
    }
    __syncwarp();
    const int t = t0 + lane;
    if (t < T) {
      int32_t* o = p.out + ((size_t)b * H + warp * 32) * T + t;
      const int rows = min(32, H - warp * 32);
      for (int i = 0; i < rows; ++i) o[(size_t)i * T] = tile[warp][i][lane];
    }
    __syncwarp();
  }
}

}  // namespace

// One launch decodes B frames' lanes of one field: (B, L, T) u16 words,
// (B, L) counts / states / lives, (B, C, A) frequencies -> (B, L, T) int32
// symbols.  mode 0: zigzag contexts (C = 4, A <= 512, L <= 32), mode 2:
// order-0 (C = 1, A <= 512, L <= 32), mode 1: wavefront bits (C = 4, A = 2,
// L <= 512).  Returns a cudaError_t (cudaErrorInvalidValue for anything
// else); launches on `stream` and does not synchronize.
extern "C" int rpcc_rans_decode_launch(
    const uint16_t* words, const int32_t* counts, const int64_t* states, const int32_t* lives,
    const int32_t* freqs, int32_t* out, int B, int L, int T, int C, int A, int mode, void* stream) {
  if (B < 1 || L < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const bool lanes = (mode == kZigzag && C == kMaxCtx) || (mode == kOrder0 && C == 1);
  if (lanes ? (L > kMaxLanes || A < 1 || A > kMaxAlphabet)
            : !(mode == kWavefront && C == kMaxCtx && A == 2 && L <= kMaxRows))
    return (int)cudaErrorInvalidValue;
  Params p{words, counts, states, lives, freqs, out, L, T, C, A};
  cudaStream_t st = (cudaStream_t)stream;
  if (!lanes) {
    rans_decode_wavefront_kernel<<<B, (L + 31) / 32 * 32, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  static bool smem_set[64] = {};  // per device, once (setting it again is harmless)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(rans_decode_lanes_kernel<kZigzag>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLanesSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rans_decode_lanes_kernel<kOrder0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kLanesSmemMax);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = true;
  }
  const size_t smem = (size_t)C * A * 8 + (size_t)C * kM * 2;
  if (mode == kZigzag)
    rans_decode_lanes_kernel<kZigzag><<<B, kLanesThreads, smem, st>>>(p);
  else
    rans_decode_lanes_kernel<kOrder0><<<B, kLanesThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}
