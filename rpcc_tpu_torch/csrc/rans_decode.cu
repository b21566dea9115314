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
// rpcc_tpu_torch/ops/rans_device.py (decode_streams_cuda, decode_fields_cuda).
//
// What bounds it: not bytes (a 64x2000 frame's words, tables and symbols are
// ~1.6 MB, ~0.5 us at 3.35 TB/s) but the chain of dependent steps of each
// lane: T steps (4000 for the 64E residual, 2064 for its contour), each a
// table lookup that depends on the state the step before made.  Nothing can
// run a lane's steps in parallel, so a step's chain is kept to two shared
// loads and a few integer instructions, and everything else runs beside it,
// after it in the shared-memory pipe, or on other warps.  The words a
// renormalization reads back used to come from device memory into a
// register prefetched a step ahead; a warp's register waits for its slowest
// lane, and with 32 lanes some lane renormalizes almost every step, so every
// step waited about one L2 round trip (python -m
// rpcc_tpu_torch.utils.chain_probe measures each latency on the card).
//
// Design: one launch decodes up to two field groups, a block per frame:
// blocks [0, B_r) a residual group (mode 0: zigzag contexts, C = 4; mode 2:
// order-0, C = 1; L <= 32 lanes, A <= 512 symbols), blocks [B_r, B_r + B_c)
// a contour group (mode 1: wavefront bits, C = 4, A = 2, H <= 512 rows), so
// a batch's two big fields run side by side rather than one after the other.
// In both, walking warps take a thread per lane and walk T steps in rounds of
// a chunk of steps, one __syncthreads() a round; producer warps (those that
// share no scheduler with a walking warp, where the block has them) work one
// round ahead and behind:
//  * Words through a shared ring.  Lane l's words are read backwards from
//    counts[l] - 1; word i (the value words[clamp(i, 0, T - 1)], as the
//    reference's gather clamps) lives at ring slot i mod R.  With the lane's
//    cursor cur at a round's start, the walker reads only words
//    [cur - S, cur) in its S steps (a step takes at most one word), while the
//    producers copy [cur - 2S, cur - S), widened to 16-byte blocks, for the
//    next round: cp.async.cg for whole aligned blocks inside the row,
//    clamped scalar copies for the rest.  R >= 2S + 7 keeps every block
//    copied off the slots of the words the walker may still read.  The
//    walker publishes its cursors in a double-buffered array before each
//    barrier.  A lane holds the word it takes next in a register and loads
//    the one after it each step (both reloaded after each barrier).
//  * Branch-free steps: the renormalization is a compare, selects and a
//    predicated cursor decrement, so the lanes never diverge; a step past a
//    lane's live count writes symbol 0 and its state is never read again.
//  * Symbols leave through a double-buffered tile in shared memory, four
//    steps a store, which the producers copy to the (B, L, T) int32 output
//    a round later, coalesced along the steps.
//  * Residual tables (all warps, before the walk): an 8-byte record per
//    (context, symbol), {f | the next step's context << 16, exclusive cum},
//    and the slot -> record table, one u16 per (context, slot) holding the
//    record's shared address; each context's slot table starts at a 32
//    KB-aligned shared address.  A step is then entry = ld.shared.u16
//    [ctx table | 2 * slot], record = ld.shared.v2 [entry], the state's
//    multiply-add and renormalization test, and a select between the two
//    candidates for the next step's table address (the new state's low bits
//    are the state's or, when it renormalizes, the word's), both formed from
//    the record's next context beside the chain.  A thread fills a run of
//    8-slot blocks with 16-byte stores, one binary search at its start and a
//    cursor over the inclusive sums after it.
//  * Contour rows: the context 2 * above + left needs row r - 1's symbol of
//    the step before: a shuffle within a warp; across warps, warp w walks a
//    round behind warp w - 1 and reads that warp's last row from the tile it
//    wrote the round before, so no warp waits on another within a round.
//    Both frequencies of each of the 4 contexts sit in registers: a step has
//    no table load (symbol = slot >= f0).
// %globaltimer stamps (optional) time the phases (tables, walk, flush) of
// the first residual block and the first contour block.
//
// The tables follow the spec for any u16 frequencies (the wire's type; the
// kernel reads each int32 frequency's low 16 bits): slot j holds the first
// symbol whose inclusive sum exceeds j, else the last symbol, as
// jnp.repeat(..., total_repeat_length=M) pads.

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
constexpr int kMinWarps = 8;
constexpr int kMaxThreads = 32 * (kMaxRows / 32 + 4);
constexpr int kPhases = 3;  // tables, walk, flush
// Residual: rounds of 64 steps, a 256-word ring per lane.
constexpr int kResChunk = 64;
constexpr int kResRing = 256;
constexpr int kResTile = kResChunk + 4;  // u16 a tile row: 34 words, 8-byte aligned, two lanes a bank pair
// Contour: rounds of 32 steps, a 128-word ring per row.
constexpr int kCntChunk = 32;
constexpr int kCntRing = 128;
constexpr int kCntTile = kCntChunk + 4;  // bytes a tile row: 9 words
static_assert(kResRing >= 2 * kResChunk + 7 && kCntRing >= 2 * kCntChunk + 7, "a ring must hold two chunks and a block");
// 16-byte blocks a lane's window spans: a round's S words, the initial 2S.
__host__ __device__ constexpr int blocks_of(int words) { return (words + 14) / 8; }

// Residual layout: {f | next context << 16, c} records at offset 0 (their
// shared addresses fit the u16 slot entries), the ring, the tile and the
// cursors, then the slot tables from the next 32 KB-aligned shared address
// (a context's table address, base + ctx * 32 KB, has 15 zero low bits, so one
// LOP3 ORs in a slot; the context's offset itself must be added, not OR-ed).
constexpr int kFcBytes = kMaxCtx * kMaxAlphabet * 8;
constexpr int kResHead = kFcBytes + kMaxLanes * kResRing * 2 + 2 * kMaxLanes * kResTile * 2 + 2 * kMaxLanes * 4;
constexpr uint32_t kCtxSpan = 2 * kM;  // bytes of one context's slot table
constexpr size_t residual_smem(int C) { return kResHead + kCtxSpan + (size_t)C * kCtxSpan; }
constexpr size_t contour_smem(int rows) {
  return (size_t)rows * kCntRing * 2 + 2 * (size_t)rows * kCntTile + 2 * (size_t)rows * 4 + 64;
}
constexpr size_t kSmemMax = residual_smem(kMaxCtx) > contour_smem(kMaxRows) ? residual_smem(kMaxCtx)
                                                                             : contour_smem(kMaxRows);

enum Mode { kZigzag = 0, kWavefront = 1, kOrder0 = 2 };

struct Group {
  const uint16_t* words;  // (B, L, T) u16, lane l's first counts[l] words
  const int32_t* counts;  // (B, L)
  const int64_t* states;  // (B, L), the u32 final encoder states
  const int32_t* lives;   // (B, L) live steps per lane
  const int32_t* freqs;   // (B, C, A), read as u16
  int32_t* out;           // (B, L, T) symbols
  int B, L, T, C, A, mode;
};

__device__ __forceinline__ void stamp(int64_t* at) {
  if (at != nullptr && threadIdx.x == 0) {
    int64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
    *at = t;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" : : "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint2 lds_v2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_u64(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" : : "r"(addr), "r"(lo), "r"(hi) : "memory");
}

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" : : "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" : : : "memory");
}

// Warp w produces unless it walks or shares a scheduler (w mod 4) with a
// walking warp, where the block has warps enough to avoid that.
__device__ __forceinline__ bool is_producer(int w, int nw) { return w >= nw && (nw >= 4 || (w & 3) >= nw); }

struct Producers {
  int tid, n;  // this thread's index among the producer threads, and their count (-1, n for others)
};

__device__ __forceinline__ Producers producers(int nw) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int before = 0, count = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (is_producer(w, nw)) {
      before += w < warp;
      ++count;
    }
  }
  return {is_producer(warp, nw) ? before * 32 + (int)(threadIdx.x & 31) : -1, count * 32};
}

// Ring slots of word indices [lo, hi) (lo, hi multiples of 8) of one lane:
// whole in-row 16-byte-aligned blocks by cp.async, the rest clamped.
template <int kRing>
__device__ __forceinline__ void fill_block(uint16_t* ring_row, const uint16_t* wrow, int i, int T) {
  uint16_t* dst = ring_row + (i & (kRing - 1));
  if (i >= 0 && i + 8 <= T && (reinterpret_cast<uintptr_t>(wrow + i) & 15) == 0) {
    cp_async16(dst, wrow + i);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) dst[q] = wrow[min(max(i + q, 0), T - 1)];
  }
}

// Each lane l < n with cursor cur[l] (and `active(l)`) gets its ring slots of
// words [cur - back, cur - front) widened to 16-byte blocks, over threads
// tid of nthr; at most kBlocks blocks a lane.
template <int kRing, int kBlocks, typename Active>
__device__ __forceinline__ void fill_windows(uint16_t* ring, const uint16_t* words, int T, const int* cur, int n,
                                             int back, int front, int tid, int nthr, Active active) {
  for (int e = tid; e < n * kBlocks; e += nthr) {
    const int l = e / kBlocks, k = e - l * kBlocks;
    if (!active(l)) continue;
    const int c = cur[l];
    const int lo = (c - back) & ~7, hi = (c - front + 7) & ~7;
    const int i = lo + 8 * k;
    if (i < hi) fill_block<kRing>(ring + l * kRing, words + (size_t)l * T, i, T);
  }
}

__device__ __forceinline__ uint32_t zigzag_ctx(uint32_t sym) {
  // (mag >= 1) + (mag >= 3) + (mag >= 8) for mag = (sym + 1) >> 1
  return (sym >= 1) + (sym >= 5) + (sym >= 15);
}

// ------------------------------------------------------------------ residual
template <int kMode>
__device__ void residual_block(const Group& g, int b, unsigned char* smem, int64_t* stamps) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = blockDim.x;
  const int L = g.L, T = g.T, C = g.C, A = g.A;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t s2s_addr = (sbase + kResHead + kCtxSpan - 1) & ~(kCtxSpan - 1);
  if (sbase + kFcBytes > 0x10000u) __trap();  // a record's address must fit a u16 entry
  uint2* fc = reinterpret_cast<uint2*>(smem);  // (C, 512) {f | next context << 16, exclusive cum}
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kFcBytes);  // (32, kResRing)
  uint16_t* tile = ring + kMaxLanes * kResRing;  // (2, 32, kResTile)
  int* cur_sm = reinterpret_cast<int*>(tile + 2 * kMaxLanes * kResTile);  // (2, 32): cursors at a round's start
  uint16_t* s2s = reinterpret_cast<uint16_t*>(smem + (s2s_addr - sbase));  // (C, M) record addresses
  stamp(stamps);
  const size_t row0 = (size_t)b * L;
  const uint16_t* words = g.words + row0 * T;
  if (tid < L) cur_sm[tid] = g.counts[row0 + tid];
  const int32_t* fq = g.freqs + (size_t)b * C * A;
  for (int i = tid; i < C * A; i += nthr) {
    const int c = i / A, a = i - c * A;
    fc[c * kMaxAlphabet + a].x = (uint16_t)fq[i] | (kMode == kZigzag ? zigzag_ctx(a) : 0u) << 16;
  }
  __syncthreads();
  auto all = [](int) { return true; };
  fill_windows<kResRing, blocks_of(2 * kResChunk)>(ring, words, T, cur_sm, L, 2 * kResChunk, 0, tid, nthr, all);
  // Exclusive sums: a warp per context, a lane per run of ceil(A / 32) symbols.
  const int per = (A + 31) / 32;
  for (int c = warp; c < C; c += nthr >> 5) {
    uint2* row = fc + c * kMaxAlphabet;
    const int lo = min(lane * per, A), hi = min(lo + per, A);
    uint32_t sum = 0;
    for (int a = lo; a < hi; ++a) sum += row[a].x & 0xffffu;
    uint32_t incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    uint32_t run = incl - sum;
    for (int a = lo; a < hi; ++a) {
      row[a].y = run;
      run += row[a].x & 0xffffu;
    }
  }
  __syncthreads();
  // Slot -> record address: a thread per run of 8-slot blocks, one 16-byte
  // store a block; one binary search over the inclusive sums at the run's
  // start, then a cursor u that only grows along it.
  {
    constexpr int kBlocksPerCtx = (int)kM / 8;
    const int nblk = C * kBlocksPerCtx, span = (nblk + nthr - 1) / nthr;
    const int b1 = min((tid + 1) * span, nblk);
    auto incl_of = [&](const uint2* row, int a) { return (row[a].x & 0xffffu) + row[a].y; };
    int ctx = -1, u = 0;
    uint32_t incl = 0;
    const uint2* row = fc;
    for (int blk = min(tid * span, nblk); blk < b1; ++blk) {
      const int c = blk / kBlocksPerCtx;
      const uint32_t j0 = (uint32_t)(blk - c * kBlocksPerCtx) * 8;
      if (c != ctx) {
        ctx = c;
        row = fc + c * kMaxAlphabet;
        int lo = 0, hi = A - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (incl_of(row, mid) <= j0) lo = mid + 1; else hi = mid;
        }
        u = lo;
        incl = incl_of(row, u);
      }
      uint32_t e[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        while (u < A - 1 && incl <= j0 + q) incl = incl_of(row, ++u);
        e[q] = sbase + (uint32_t)(c * kMaxAlphabet + u) * 8u;
      }
      *reinterpret_cast<uint4*>(s2s + (size_t)blk * 8) =
          make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  stamp(stamps ? stamps + 1 : nullptr);

  const int nchunks = (T + kResChunk - 1) / kResChunk;
  const Producers pr = producers(1);
  auto flush = [&](int r, int ftid, int fn) {  // chunk r's symbols from the tile to out
    const int t0 = r * kResChunk, n = min(kResChunk, T - t0);
    const uint16_t* src = tile + (r & 1) * kMaxLanes * kResTile;
    for (int e = ftid; e < L * kResChunk; e += fn) {
      const int l = e / kResChunk, k = e - l * kResChunk;
      if (k < n) g.out[(row0 + l) * T + t0 + k] = src[l * kResTile + k];
    }
  };
  if (warp == 0) {
    // A step's chain: the slot's table entry, its record, the state's
    // multiply-add, the renormalization test, and a select between the two
    // next table addresses.  The word after the next is loaded each step
    // after the record (its address reads the record), and the symbols leave
    // four steps at a time, so neither queues ahead of the chain's loads in
    // the shared-memory pipe.
    const bool mine = lane < L;
    uint32_t x = mine ? (uint32_t)g.states[row0 + lane] : 0u;
    int cur = mine ? g.counts[row0 + lane] : 0;
    const int live = mine ? min(max(g.lives[row0 + lane], 0), T) : 0;
    const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring + lane * kResRing);
    uint32_t addr = s2s_addr | ((x << 1) & (kCtxSpan - 2));  // context 0 at t == 0
    uint32_t w1 = 0;
    auto step = [&](int t) -> uint32_t {
      const uint32_t entry = lds_u16(addr);
      const uint2 rec = lds_v2(entry);
      // the word after the next, issued after the record (c < 2^25: its bit 31 adds 0)
      const uint32_t w2 = lds_u16(ring_addr + (((cur - 2) & (kResRing - 1)) << 1) + (rec.y >> 31));
      const uint32_t next_ctx = s2s_addr + ((rec.x >> 16) << (kProbBits + 1));
      const uint32_t x1 = (rec.x & 0xffffu) * (x >> kProbBits) + (x & (kM - 1)) - rec.y;
      const bool need = x1 < kRansL;
      uint32_t keep = (x1 << 1) & (kCtxSpan - 2) | next_ctx, take = (w1 << 1) & (kCtxSpan - 2) | next_ctx;
      asm("" : "+r"(keep), "+r"(take));  // both candidates first: a select after the test, not before the mask
      addr = need ? take : keep;
      x = need ? (x1 << 16) | w1 : x1;
      cur -= need;
      w1 = need ? w2 : w1;
      return t < live ? ((entry - sbase) >> 3) & (kMaxAlphabet - 1) : 0u;
    };
    for (int r = 0; r < nchunks; ++r) {
      const int t0 = r * kResChunk, n = min(kResChunk, T - t0);
      uint16_t* trow = tile + ((r & 1) * kMaxLanes + lane) * kResTile;
      const uint32_t trow_addr = (uint32_t)__cvta_generic_to_shared(trow);
      w1 = ring[lane * kResRing + ((cur - 1) & (kResRing - 1))];
      int k = 0;
      for (; k + 4 <= n; k += 4) {
        const uint32_t s0 = step(t0 + k), s1 = step(t0 + k + 1), s2 = step(t0 + k + 2), s3 = step(t0 + k + 3);
        sts_u64(trow_addr + 2 * k, s0 | s1 << 16, s2 | s3 << 16);
      }
      for (; k < n; ++k) trow[k] = (uint16_t)step(t0 + k);
      cur_sm[((r + 1) & 1) * kMaxLanes + lane] = cur;
      __syncthreads();
    }
  } else {
    for (int r = 0; r < nchunks; ++r) {
      if (pr.tid >= 0) {
        if (r > 0) flush(r - 1, pr.tid, pr.n);
        fill_windows<kResRing, blocks_of(kResChunk)>(ring, words, T, cur_sm + (r & 1) * kMaxLanes, L,
                                                     2 * kResChunk, kResChunk, pr.tid, pr.n, all);
        cp_async_wait_all();
      }
      __syncthreads();
    }
  }
  stamp(stamps ? stamps + 2 : nullptr);
  flush(nchunks - 1, tid, nthr);
  __syncthreads();
  stamp(stamps ? stamps + 3 : nullptr);
}

// ------------------------------------------------------------------ contour
__device__ void contour_block(const Group& g, int b, unsigned char* smem, int64_t* stamps) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = blockDim.x;
  const int H = g.L, T = g.T, nw = (H + 31) / 32, rows = nw * 32;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);  // (rows, kCntRing)
  uint8_t* tile = reinterpret_cast<uint8_t*>(ring + (size_t)rows * kCntRing);  // (2, rows, kCntTile)
  int* cur_sm = reinterpret_cast<int*>(tile + 2 * rows * kCntTile);  // (2, rows)
  uint8_t* zero = reinterpret_cast<uint8_t*>(cur_sm + 2 * rows);  // the row above row 0
  stamp(stamps);
  const size_t row0 = (size_t)b * H;
  const uint16_t* words = g.words + row0 * T;
  for (int i = tid; i < H; i += nthr) cur_sm[i] = g.counts[row0 + i];
  if (tid < 16) reinterpret_cast<uint32_t*>(zero)[tid] = 0u;
  __syncthreads();
  auto all = [](int) { return true; };
  fill_windows<kCntRing, blocks_of(2 * kCntChunk)>(ring, words, T, cur_sm, H, 2 * kCntChunk, 0, tid, nthr, all);
  const int row = warp * 32 + lane;
  const bool mine = warp < nw && row < H;
  uint32_t x = mine ? (uint32_t)g.states[row0 + row] : 0u;
  int cur = mine ? g.counts[row0 + row] : 0;
  const int live = mine ? min(max(g.lives[row0 + row], 0), T) : 0;
  // f0 and f1 of contexts 0..3 (c0 = 0, c1 = f0)
  const int32_t* fq = g.freqs + (size_t)b * 8;
  uint32_t f0[4], f1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f0[c] = warp < nw ? (uint16_t)fq[2 * c] : 0u;
    f1[c] = warp < nw ? (uint16_t)fq[2 * c + 1] : 0u;
  }
  cp_async_wait_all();
  __syncthreads();
  stamp(stamps ? stamps + 1 : nullptr);

  const int nchunks = (T + kCntChunk - 1) / kCntChunk, nrounds = nchunks + nw - 1;
  const Producers pr = producers(nw);
  auto flush = [&](int r, int ftid, int fn) {  // the chunks walked in round r (warp w's chunk r - w)
    for (int e = ftid; e < rows * kCntChunk; e += fn) {
      const int rr = e / kCntChunk, k = e - rr * kCntChunk, j = r - (rr >> 5), t = j * kCntChunk + k;
      if (rr < H && j >= 0 && j < nchunks && t < T)
        g.out[(row0 + rr) * T + t] = tile[((j & 1) * rows + rr) * kCntTile + k];
    }
  };
  if (warp < nw) {
    const uint16_t* my_ring = ring + row * kCntRing;
    const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(my_ring);
    uint32_t left = 0, above = 0;
    for (int r = 0; r < nrounds; ++r) {
      const int j = r - warp;
      if (j >= 0 && j < nchunks) {
        const int t0 = j * kCntChunk, n = min(kCntChunk, T - t0);
        uint8_t* trow = tile + ((j & 1) * rows + row) * kCntTile;
        // lane 0: the last row of the warp above, walked last round (row 0: zeros)
        const uint8_t* erow = row == 0 ? zero : tile + ((j & 1) * rows + row - 1) * kCntTile;
        const uint32_t trow_addr = (uint32_t)__cvta_generic_to_shared(trow);
        uint32_t w1 = my_ring[(cur - 1) & (kCntRing - 1)];
        auto step = [&](int t, uint32_t edge) -> uint32_t {
          const uint32_t w2 = lds_u16(ring_addr + (((cur - 2) & (kCntRing - 1)) << 1));
          const uint32_t slot = x & (kM - 1);
          const uint32_t c0 = left ? f0[1] : f0[0], c1 = left ? f0[3] : f0[2];
          const uint32_t d0 = left ? f1[1] : f1[0], d1 = left ? f1[3] : f1[2];
          const uint32_t a0 = above ? c1 : c0, a1 = above ? d1 : d0;
          const uint32_t bit = slot >= a0;
          const uint32_t x1 = (bit ? a1 : a0) * (x >> kProbBits) + slot - (bit ? a0 : 0u);
          const bool need = x1 < kRansL;
          x = need ? (x1 << 16) | w1 : x1;
          cur -= need;
          w1 = need ? w2 : w1;
          const uint32_t s = t < live ? bit : 0u;
          left = s;
          const uint32_t up = __shfl_up_sync(0xffffffffu, s, 1);
          above = lane == 0 ? edge : up;
          return s;
        };
        int k = 0;
        for (; k + 4 <= n; k += 4) {
          const uint32_t e4 = *reinterpret_cast<const uint32_t*>(erow + k);  // lane 0's four edge symbols
          const uint32_t s0 = step(t0 + k, e4 & 0xff), s1 = step(t0 + k + 1, (e4 >> 8) & 0xff);
          const uint32_t s2 = step(t0 + k + 2, (e4 >> 16) & 0xff), s3 = step(t0 + k + 3, e4 >> 24);
          sts_u32(trow_addr + k, s0 | s1 << 8 | s2 << 16 | s3 << 24);
        }
        for (; k < n; ++k) trow[k] = (uint8_t)step(t0 + k, erow[k]);
      }
      cur_sm[((r + 1) & 1) * rows + row] = cur;
      __syncthreads();
    }
  } else {
    for (int r = 0; r < nrounds; ++r) {
      if (pr.tid >= 0) {
        if (r > 0) flush(r - 1, pr.tid, pr.n);
        auto walking = [&](int rr) { const int j = r - (rr >> 5); return j >= 0 && j < nchunks; };
        fill_windows<kCntRing, blocks_of(kCntChunk)>(ring, words, T, cur_sm + (r & 1) * rows, H, 2 * kCntChunk,
                                                     kCntChunk, pr.tid, pr.n, walking);
        cp_async_wait_all();
      }
      __syncthreads();
    }
  }
  stamp(stamps ? stamps + 2 : nullptr);
  flush(nrounds - 1, tid, nthr);
  __syncthreads();
  stamp(stamps ? stamps + 3 : nullptr);
}

__global__ void __launch_bounds__(kMaxThreads) rans_decode_kernel(Group res, Group cnt, int64_t* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < res.B) {
    int64_t* st = stamps != nullptr && blockIdx.x == 0 ? stamps : nullptr;
    if (res.mode == kZigzag)
      residual_block<kZigzag>(res, blockIdx.x, smem, st);
    else
      residual_block<kOrder0>(res, blockIdx.x, smem, st);
  } else {
    int64_t* st = stamps != nullptr && (int)blockIdx.x == res.B ? stamps + kPhases + 1 : nullptr;
    contour_block(cnt, blockIdx.x - res.B, smem, st);
  }
}

bool residual_ok(const Group& g) {
  return g.L >= 1 && g.L <= kMaxLanes && g.T >= 1 && g.A >= 1 && g.A <= kMaxAlphabet &&
         ((g.mode == kZigzag && g.C == kMaxCtx) || (g.mode == kOrder0 && g.C == 1));
}

bool contour_ok(const Group& g) {
  return g.L >= 1 && g.L <= kMaxRows && g.T >= 1 && g.C == kMaxCtx && g.A == 2 && g.mode == kWavefront;
}

}  // namespace

// One launch decodes a residual group (B_r frames: (B_r, L, T_r) u16 words,
// (B_r, L) counts / states / lives, (B_r, C, A) frequencies -> (B_r, L, T_r)
// int32 symbols; mode 0: zigzag contexts, C = 4; mode 2: order-0, C = 1;
// L <= 32, A <= 512) and a contour group (B_c frames of H <= 512 rows of T_c
// wavefront bits, (B_c, 4, 2) frequencies), a block per frame; either B may
// be 0.  `stamps`: null, or 2 x 4 int64 %globaltimer values (ns) at the
// bounds of the phases of the first residual block, then of the first
// contour block.  Returns a cudaError_t (cudaErrorInvalidValue for anything
// else); launches on `stream` and does not synchronize.
extern "C" int rpcc_rans_decode_fields_launch(
    const uint16_t* r_words, const int32_t* r_counts, const int64_t* r_states, const int32_t* r_lives,
    const int32_t* r_freqs, int32_t* r_out, int B_r, int L, int T_r, int C, int A, int mode,
    const uint16_t* c_words, const int32_t* c_counts, const int64_t* c_states, const int32_t* c_lives,
    const int32_t* c_freqs, int32_t* c_out, int B_c, int H, int T_c, int64_t* stamps, void* stream) {
  const Group res{r_words, r_counts, r_states, r_lives, r_freqs, r_out, B_r, L, T_r, C, A, mode};
  const Group cnt{c_words, c_counts, c_states, c_lives, c_freqs, c_out, B_c, H, T_c, kMaxCtx, 2, kWavefront};
  if (res.B < 0 || cnt.B < 0 || res.B + cnt.B < 1 || (res.B > 0 && !residual_ok(res)) ||
      (cnt.B > 0 && !contour_ok(cnt)))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};  // per device, once (setting it again is harmless)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = true;
  }
  const int nw = cnt.B > 0 ? (cnt.L + 31) / 32 : 0;
  const int threads = 32 * (nw + 4 > kMinWarps ? nw + 4 : kMinWarps);
  size_t smem = 0;
  if (res.B > 0) smem = residual_smem(res.C);
  if (cnt.B > 0 && contour_smem(nw * 32) > smem) smem = contour_smem(nw * 32);
  rans_decode_kernel<<<res.B + cnt.B, threads, smem, (cudaStream_t)stream>>>(res, cnt, stamps);
  return (int)cudaGetLastError();
}
