// rANS encode of the residual stream and the contour plane on Hopper (sm_90a).
//
// Replaces the XLA programs of rpcc_tpu/ops/rans_device.py
// (encode_residual_field_device and encode_contour_field_device, whose
// encode_field_device walks the lanes in one lax.scan of T dependent steps:
// the engine's device entropy) and of rpcc_tpu/ops/rans.py
// (encode_streams_batch_ctx and encode_streams_batch_ctx_explicit: the host
// containers' encode under RPCC_RANS_DEVICE=default).  Neither was a Pallas
// kernel, but in eager PyTorch a scan is ~10 launches a step, ~60,000 a
// batch, so the port needs one kernel.  Semantics, and the plain PyTorch
// version every output equals: rpcc_tpu_torch/ops/rans_device.py.  The
// residual block codes L lanes of T steps, both launch arguments: the
// engine's 32 x resid_T(HW), or the host containers' geometry (L = 1 .. 32
// from the longest frame's length, T from it in multiples of 16).
//
// What bounds it: not bytes (~1.6 MB a 64x2000 frame, ~0.5 us at 3.35 TB/s)
// but the chain of dependent steps of each lane: 4000 for the 64E residual
// (32 lanes), 2064 for its contour (64 lanes).  Nothing
// can run a lane's steps in parallel, so the design shortens one step and
// takes everything else off the walking warp's path and off its scheduler.
//
// Design: one launch per batch, one 512-thread block per frame and field
// (blocks [0, B_res) code residual streams, [B_res, B_res + B_cnt) contour
// planes).  A block
//   1. computes every step's joint (context, symbol) key from q (or from the
//      contour bits and their wavefront shear), writes it to a u16 key array
//      in global memory (lane-major, the stream's own order) and histograms
//      it, on 32-bit indices with no divide a position: each warp owns a
//      contiguous range, a thread four consecutive positions of one lane a
//      round (one 16-byte load of q where its rows allow; the two values
//      before them from the lane before), four rounds of loads in flight.
//      Keys of symbols below 8 (~98% of a 64E frame's) are counted in the
//      thread's own counters (the commonest in a register, the others in
//      shared memory), since most keys of a warp are
//      equal and shared atomics on one address serialize; the others with a
//      shared atomic.  Escapes are scanned in stream order into a per-warp
//      list, and one scan of the warp counts places them after the pass's
//      single barrier.  The contour's 8 bins are counted in registers.
//      Residual steps past stream_len get one more key (f = M, c = 0), whose
//      step leaves the state alone and emits nothing: the walk has no
//      liveness branch;
//   2. normalizes each context row with one warp, in f32 with __fdiv_rn /
//      __fmul_rn in the reference's order, ties of the argmax to the first
//      index, including the repair pass, and builds a 16-byte record per
//      key in shared memory (make_record; a residual record at its key's
//      slot, which spreads the common keys over the banks): the multiplier
//      and shifts of an
//      exact multiply-high division by f, xm1 = (f << 18) - 1 (the
//      renormalization test is one compare), c and M - f;
//   3. walks: warp 0 (the residual's L <= 32 lanes) or ceil(L / 32) warps (the
//      contour's lanes, in passes of L <= 128: four walking warps at most,
//      one per scheduler, so a contour of more rows is walked 128 lanes at a
//      time), a thread per lane, all T steps in reverse, in
//      chunks of 128 steps (64 past 64 lanes) that pass through a 4-stage
//      ring in shared memory: producer warps hand chunks over on named
//      barriers (bar.arrive / bar.sync), fed from the precomputed key
//      array rather than a TMA copy by the walker: the producers copy a
//      chunk's keys into the ring (16-byte copies) up to four chunks ahead,
//      and drain each walked chunk, a warp per lane partitioning its words
//      by their emit bits into the lane's row of a scratch array (emitted
//      from the front, the others from the back).  Producers that computed
//      the keys from q themselves issued ~20x the walker's instructions and
//      took its scheduler's issue slots (76 ns a step, on the card); these
//      copy, and are only the warps that share no scheduler with a walking
//      warp (warp w runs on sub-partition w % 4).  A step (rans_step):
//      emit = x > xm1; t = umulhi(m, x), u = t + ((x - t) >> sh1); q = u >>
//      sh2, or u >> (sh2 + 16) when emitting (the quotient of x >> 16:
//      Granlund-Montgomery's round-up method, exact for every u32 x and f in
//      [1, 2^14], whose multiplier for f << 16 is the one for f); x' = x_r +
//      c + q * (M - f).  The chain of x is 6 dependent instructions (umulhi,
//      sub, shift, add, shift, multiply-add: the walk loop's SASS, read by
//      python -m rpcc_tpu_torch.utils.rans_sass), with the test and the selects beside it, and
//      ~23 instructions a step in all.  Words and emit bits stay in
//      registers and go to the ring eight steps at a time (one 16-byte
//      store), and the next eight steps' keys (one 16-byte load) and records
//      load while the current eight run: the walking warp never waits on
//      memory;
//   4. packs: lane offsets by a warp scan, then the whole block copies every
//      lane's emitted prefix forward and its suffix in reverse
//      (row[T - 1 - j]) on 32-bit offsets, a warp on a contiguous segment of
//      a row: 4-byte loads, u16 stores (the destination offsets are
//      arbitrary word positions).
// No host sync: the kernel reads stream_len on the device.  %globaltimer
// stamps (optional) time the four phases in frame 0's residual block and in
// frame 0's contour block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kM = 1u << 14;     // PROB_BITS = 14
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxLanes = 32;         // residual lanes, at most (one walking warp)
constexpr int kAlphabet = 512;
constexpr uint32_t kEscape = kAlphabet - 1;
constexpr int kCtx = 4;
constexpr int kKeys = kCtx * kAlphabet;
constexpr int kDead = kKeys;          // the key of a residual step past stream_len
constexpr int kEscCap = 512;
constexpr int kMaxRows = 512;         // contour lanes, at most
constexpr int kPassRows = 128;        // contour lanes a walk pass: 4 walking warps
constexpr int kStages = 4;            // ring stages
constexpr int kMaxChunk = 128;        // steps a chunk, at most (a multiple of 32)
constexpr int kRingBytes = 155648;    // keys, words and emit masks of every stage
constexpr int kVec = 4;               // consecutive positions a histogram thread keys a round (one lane's)
constexpr int kRounds = 4;            // rounds a histogram thread loads at once
constexpr int kPackPairs = 16;        // word pairs a packing thread has in flight
constexpr int kRun = 16;              // T is a multiple of this (the containers' T bucket)
constexpr int kPhases = 4;            // histogram, normalize, walk, pack
// Dynamic shared memory: phase 1 of a residual block holds each thread's
// counters of the small keys and kWarps escape lists; phases 2-3 reuse the
// space for the records and the ring.
constexpr int kSmallSyms = 8;         // keys of symbols < 8 (~98% of a 64E frame's) are counted per thread
constexpr int kOwnBytes = kCtx * kSmallSyms * kThreads * 4;
constexpr int kEscListBytes = kWarps * kEscCap * 4;
constexpr int kRecords = kKeys + 8;   // a residual record per slot (slot_of), 8 of them the dead key's
constexpr int kRecBytes = (kRecords * 16 + 127) / 128 * 128;
constexpr int kSmemBytes = kOwnBytes + kEscListBytes > kRecBytes + kRingBytes
                               ? kOwnBytes + kEscListBytes : kRecBytes + kRingBytes;

struct Params {
  const int32_t* q;           // (B_res, hw)
  const int32_t* stream_len;  // (B_res,)
  int b_res, hw, l_res, t_res;  // l_res lanes (a power of two, at most 32) of t_res steps, l_res * t_res >= hw
  const int32_t* contour;     // (B_cnt, H, W)
  int b_cnt, H, W, t_cnt;
  int16_t* r_words;   // (B_res, l_res * t_res)
  int32_t* r_nw;      // (B_res,)
  int32_t* r_counts;  // (B_res, l_res)
  int64_t* r_states;  // (B_res, l_res)
  int32_t* r_freqs;   // (B_res, 4, 512)
  int64_t* r_esc;     // (B_res, 512)
  int32_t* r_nesc;    // (B_res,)
  int32_t* r_q0;      // (B_res,)
  int16_t* c_words;   // (B_cnt, H * t_cnt)
  int32_t* c_nw;      // (B_cnt,)
  int32_t* c_counts;  // (B_cnt, H)
  int64_t* c_states;  // (B_cnt, H)
  int32_t* c_freqs;   // (B_cnt, 4, 2)
  uint16_t* keys;     // scratch keys: residual frames' l_res * t_res, then contour frames' H * t_cnt
  uint16_t* rows;     // scratch words, same layout
  int64_t* stamps;    // null, or 2 x (kPhases + 1) %globaltimer values (ns): frame 0's residual, then contour block
};

__device__ __forceinline__ void stamp(int64_t* at) {
  if (at != nullptr && threadIdx.x == 0) {
    int64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
    *at = t;
  }
}

// Named barriers of the ring, among n threads: stage s is full (1 + s) or
// walked (1 + kStages + s).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" : : "r"(id), "r"(n) : "memory");
}

// A running (row, column) position in rows of T advanced by a fixed stride
// d = a * T + b (b < T), branch-free, so the loads that follow each advance
// are not held behind a branch.
struct Cursor {
  int r, t, a, b, T;
  __device__ Cursor(int pos, int d, int T_) : r(pos / T_), t(pos % T_), a(d / T_), b(d % T_), T(T_) {}
  __device__ __forceinline__ void advance() {
    t += b;
    r += a;
    const bool wrap = t >= T;
    t -= wrap ? T : 0;
    r += wrap;
  }
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Zigzag value of a residual delta (wrapped as an int32, as in the
// reference); the delta at stream position p is 0 at p == 0 and at or past n.
__device__ __forceinline__ uint32_t zigzag(uint32_t d) { return ((int32_t)d >= 0) ? (d << 1) : ((~d << 1) | 1u); }

__device__ __forceinline__ uint32_t sym_of(uint32_t zz) { return zz >= kEscape ? kEscape : zz; }

// A residual key's slot among the records: within a context's row the
// symbols of each group of 8 are rotated by 3 * ctx, so that the commonest
// keys (the small symbols of contexts 0-2) fall on different shared-memory
// bank groups (a 16-byte record spans 4 of the 32 banks) and the walking
// warp's record loads conflict less.  The dead key (ctx 4) lands in 2048-2055.
__device__ __forceinline__ uint32_t slot_of(uint32_t key) {
  return (key & ~7u) | ((key + 3 * (key >> 9)) & 7u);
}

__device__ __forceinline__ uint32_t key_of_slot(uint32_t slot) {
  return (slot & ~7u) | ((slot - 3 * (slot >> 9)) & 7u);
}

__device__ __forceinline__ int zigzag_ctx(uint32_t prev) {
  uint32_t mag = (prev + 1) >> 1;
  return (mag >= 1) + (mag >= 3) + (mag >= 8);
}

// One warp normalizes one row of A counts to freqs summing to kM (the
// reference's normalize_freqs, bit for bit) and writes their exclusive
// prefix sums.  Lane k owns the contiguous entries [k * chunk, ...).
__device__ void normalize_row(const int* cnt, int* freq, uint32_t* cum, int A, int32_t* out) {
  const int lane = threadIdx.x & 31;
  const int chunk = (A + 31) / 32;
  const int lo = min(A, lane * chunk), hi = min(A, lo + chunk);
  int tot = 0, apos = 0;
  for (int a = lo; a < hi; ++a) {
    tot += cnt[a];
    apos += cnt[a] > 0;
  }
  tot = warp_sum(tot);
  apos = warp_sum(apos);
  const float total = (float)max(tot, 1);
  for (int pass = 0; pass < 2; ++pass) {
    const float scale = pass == 0 ? __fdiv_rn((float)kM, total) : __fdiv_rn((float)((int)kM - apos), total);
    int sum = 0, best_v = INT_MIN, best_i = A;
    for (int a = lo; a < hi; ++a) {
      int v = (int)floorf(__fmul_rn((float)cnt[a], scale));
      if (pass == 0) {
        if (cnt[a] > 0 && v == 0) v = 1;
      } else {
        v += cnt[a] > 0;
      }
      freq[a] = v;
      sum += v;
      if (v > best_v) best_v = v, best_i = a;
    }
    for (int o = 16; o > 0; o >>= 1) {  // argmax, the first index on ties
      int ov = __shfl_xor_sync(0xffffffffu, best_v, o), oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ov > best_v || (ov == best_v && oi < best_i)) best_v = ov, best_i = oi;
    }
    const int delta = (int)kM - warp_sum(sum);
    __syncwarp();
    if (pass == 1 || best_v + delta >= 1) {
      if (lane == 0) freq[best_i] += delta;
      break;
    }
    __syncwarp();
  }
  __syncwarp();
  uint32_t run = 0;
  for (int a = lo; a < hi; ++a) run += (uint32_t)freq[a];
  uint32_t incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  uint32_t acc = incl - run;
  for (int a = lo; a < hi; ++a) {
    cum[a] = acc;
    acc += (uint32_t)freq[a];
    out[a] = freq[a];
  }
}

// The step's record for frequency f in [1, M] (0, a key no position has,
// is built as 1) and cumulative c: {m, xm1, c | (M - f) << 16, sh1 | sh2 << 8
// | (sh2 + 16) << 16} (each shift read as the low 5 bits of a shifted copy of
// the word, by a funnel shift, which takes its amount mod 32) with l = ceil(log2 f), m = floor(2^32 (2^l - f) / f) + 1,
// sh1 = min(l, 1), sh2 = max(l - 1, 0), xm1 = (f << 18) - 1 in u32
// (0xFFFFFFFF at f = M, so x > xm1 never holds there, as (x >> 18) >= M
// never does).  With t = umulhi(m, x) and u = t + ((x - t) >> sh1),
// x / f = u >> sh2 and (x >> 16) / f = u >> (sh2 + 16) (Granlund-Montgomery's
// round-up method; the multiplier for f << 16 is the one for f).
__device__ __forceinline__ uint4 make_record(uint32_t f, uint32_t c) {
  f = max(f, 1u);
  const uint32_t l = f > 1 ? 32 - __clz(f - 1) : 0;
  // floor(a * 2^32 / f) with a = 2^l - f < f <= 2^14, by two 32-bit long-division digits of 14 and 18 bits.
  const uint32_t a = (1u << l) - f, hi = (a << 18) / f, lo = (((a << 18) - hi * f) << 14) / f;
  const uint32_t m = (hi << 14) + lo + 1;
  const uint32_t sh2 = max(l, 1u) - 1u;
  return make_uint4(m, (f << 18) - 1u, c | ((kM - f) << 16), min(l, 1u) | (sh2 << 8) | ((sh2 + 16) << 16));
}

// One rANS step in reverse, branch-free, given the renormalization test
// `emit` (x > xm1): x' = (x_r / f) * M + c + x_r % f with x_r = x >> 16 if
// emitted, else x, written as x_r + c + q * (M - f).  Both quotients come
// from one multiply-high of x, so the chain of x is umulhi, sub, shift, add,
// shift, multiply-add; the test and the selects run beside it.
__device__ __forceinline__ uint32_t rans_step(uint32_t x, bool emit, const uint4 r) {
  const uint32_t t = __umulhi(r.x, x);
  const uint32_t u = t + __funnelshift_r(x - t, 0u, r.w);
  const uint32_t q = __funnelshift_r(u, 0u, emit ? r.w >> 16 : r.w >> 8);
  return (emit ? x >> 16 : x) + (r.z & 0xFFFFu) + q * (r.z >> 16);
}

// The ring of a field of L lanes: chunks of S steps (a multiple of 32),
// each lane's keys and words in rows of S + 8 u16 (16-byte aligned, and
// conflict-free for the 16-byte accesses of a warp), its emit bits in S / 32
// words; the walking warps' and the producer warps' roles.
struct Ring {
  int L, S, pitch;
  uint16_t* keys;   // kStages x L x pitch
  uint16_t* words;  // kStages x L x pitch
  uint32_t* masks;  // kStages x L x S / 32
  int walkers, producers, n;  // warps, warps, threads at the ring's barriers
  bool slots;  // the keys are residual keys, read through slot_of
};

__device__ __forceinline__ bool is_producer(int warp, int walkers) {
  return warp >= walkers && (walkers >= 4 || warp % 4 >= walkers);
}

__device__ Ring make_ring(unsigned char* base, int L, bool slots) {
  Ring rg;
  rg.L = L;
  rg.slots = slots;
  rg.S = kMaxChunk;
  while (rg.S > 32 && kStages * L * ((rg.S + 8) * 4 + rg.S / 8) > kRingBytes) rg.S -= 32;
  rg.pitch = rg.S + 8;
  rg.keys = reinterpret_cast<uint16_t*>(base);
  rg.words = rg.keys + kStages * L * rg.pitch;
  rg.masks = reinterpret_cast<uint32_t*>(rg.words + kStages * L * rg.pitch);
  rg.walkers = (L + 31) / 32;
  rg.producers = 0;
  for (int w = 0; w < kWarps; ++w) rg.producers += is_producer(w, rg.walkers);
  rg.n = (rg.walkers + rg.producers) * 32;
  return rg;
}

// The records of the eight steps whose keys a 16-byte load gave, last key
// first (the walk runs down the chunk).
__device__ __forceinline__ void load_records(const uint4* rec, uint4 kv, uint4 (&out)[8]) {
  const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = rec[(kw[(7 - i) >> 1] >> (((7 - i) & 1) * 16)) & 0xFFFFu];
}

// Eight steps of a lane with their records: each step's word (x's low half
// before it) is kept and the eight written to wr[j, j + 8) with one 16-byte
// store; its emit bit is shifted into m (the latest step in bit 0).
__device__ __forceinline__ uint32_t eight_steps(uint32_t x, const uint4 (&r)[8], int j, uint16_t* wr, uint32_t& m) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = x;
    const bool emit = x > r[i].y;
    m = (m << 1) | emit;
    x = rans_step(x, emit, r[i]);
  }
  *reinterpret_cast<uint4*>(wr + j) = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                                                  __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
  return x;
}

// The walking side: thread `col` codes its lane, every step of every chunk,
// chunk k holding steps [T - k*S - cnt, T - k*S) in ascending order in the
// ring; returns the final state.  Words and emit bits go to the ring in
// emission order.  Two groups of eight records alternate, so one group's
// loads (keys, then records) run while the other group's steps do.
__device__ uint32_t walk_lane(const uint4* rec, const Ring& rg, int col, bool active, int T) {
  const int nchunks = (T + rg.S - 1) / rg.S;
  uint32_t x = kRansL;
  for (int k = 0; k < nchunks; ++k) {
    const int s = k % kStages;
    bar_sync(1 + s, rg.n);
    if (active) {
      const int cnt = min(rg.S, T - k * rg.S);  // a multiple of kRun
      const uint16_t* kr = rg.keys + (s * rg.L + col) * rg.pitch;
      uint16_t* wr = rg.words + (s * rg.L + col) * rg.pitch;
      uint32_t* mr = rg.masks + (s * rg.L + col) * (rg.S / 32);
      // The keys of steps [j, j + 8), clamped to the chunk's first eight.
      auto keys_at = [&](int j) { return *reinterpret_cast<const uint4*>(kr + max(cnt - 8 - j, 0)); };
      uint4 a[8], b[8];
      load_records(rec, keys_at(0), a);
      uint32_t m = 0;
      for (int j = 0; j < cnt; j += 16) {
        load_records(rec, keys_at(j + 8), b);
        x = eight_steps(x, a, j, wr, m);
        load_records(rec, keys_at(j + 16), a);
        x = eight_steps(x, b, j + 8, wr, m);
        if (((j + 16) & 31) == 0 || j + 16 == cnt) {
          mr[j >> 5] = __brev(m) >> (31 - (j & 31) - 15);  // step j' of the 32-step group in bit j' & 31
          m = 0;
        }
      }
    }
    bar_arrive(1 + kStages + s, rg.n);
  }
  return x;
}

// Producer thread pt of np copies chunk k's keys from the key array (lane
// rows of T) into stage s, 16 bytes at a time, four loads in flight; a
// residual key becomes its record's slot (slot_of) on the way.
__device__ void fill_keys(const Ring& rg, int s, int k, const uint16_t* keys, int T, int pt, int np) {
  const int cnt = min(rg.S, T - k * rg.S), lo = T - k * rg.S - cnt, per = cnt / 8, items = rg.L * per;
  for (int i0 = pt; i0 < items; i0 += 4 * np) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = min(i0 + u * np, items - 1), l = i / per;
      v[u] = *reinterpret_cast<const uint4*>(keys + l * T + lo + (i - l * per) * 8);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (rg.slots) {
        auto pair = [](uint32_t w) { return slot_of(w & 0xFFFFu) | (slot_of(w >> 16) << 16); };
        v[u] = make_uint4(pair(v[u].x), pair(v[u].y), pair(v[u].z), pair(v[u].w));
      }
      const int i = i0 + u * np, l = i / per;
      if (i < items) *reinterpret_cast<uint4*>(rg.keys + (s * rg.L + l) * rg.pitch + (i - l * per) * 8) = v[u];
    }
  }
}

// Producer warp pw of P drains stage s (cnt steps walked) for its lanes
// l = pw, pw + P, ...: each word to the front of the lane's row if it was
// emitted, else to the back, in emission order; ne / nn count them.  Every
// lane of the warp reads the whole emit mask, so ranks are popcounts.
__device__ void drain(const Ring& rg, int s, int cnt, uint16_t* rows, int T, int pw, int P, int* ne, int* nn) {
  constexpr int kGroups = kMaxChunk / 32;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int l = pw; l < rg.L; l += P) {
    const uint16_t* wr = rg.words + (s * rg.L + l) * rg.pitch;
    const uint32_t* mr = rg.masks + (s * rg.L + l) * (rg.S / 32);
    uint16_t* row = rows + l * T;
    uint16_t w[kGroups];
    uint32_t mk[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      w[g] = wr[min(g * 32 + lane, cnt - 1)];
      mk[g] = g * 32 < cnt ? mr[g] : 0u;
    }
    int e_run = ne[l], n_run = nn[l];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int left = cnt - g * 32;
      const unsigned valid = left >= 32 ? 0xffffffffu : left > 0 ? (1u << left) - 1u : 0u;
      const unsigned em = mk[g] & valid, sil = ~mk[g] & valid;
      if ((em >> lane) & 1u)
        row[e_run + __popc(em & lt)] = w[g];
      else if ((sil >> lane) & 1u)
        row[T - 1 - (n_run + __popc(sil & lt))] = w[g];
      e_run += __popc(em);
      n_run += __popc(sil);
    }
    __syncwarp();  // every lane has read ne[l] and nn[l]
    if (lane == 0) {
      ne[l] = e_run;
      nn[l] = n_run;
    }
  }
}

// The producing side of one field: fill stages ahead, drain each walked one.
__device__ void produce(const Ring& rg, const uint16_t* keys, uint16_t* rows, int T, int pw, int* ne, int* nn) {
  const int lane = threadIdx.x & 31;
  const int nchunks = (T + rg.S - 1) / rg.S;
  for (int l = pw; l < rg.L; l += rg.producers)
    if (lane == 0) ne[l] = nn[l] = 0;
  for (int k = 0; k < nchunks; ++k) {
    const int s = k % kStages;
    if (k >= kStages) {
      bar_sync(1 + kStages + s, rg.n);
      drain(rg, s, rg.S, rows, T, pw, rg.producers, ne, nn);  // chunk k - kStages: never the last, so full
    }
    fill_keys(rg, s, k, keys, T, pw * 32 + lane, rg.producers * 32);
    bar_arrive(1 + s, rg.n);
  }
  for (int k = max(0, nchunks - kStages); k < nchunks; ++k) {
    const int s = k % kStages;
    bar_sync(1 + kStages + s, rg.n);
    drain(rg, s, min(rg.S, T - k * rg.S), rows, T, pw, rg.producers, ne, nn);
  }
}

// Phase 3 of a block: the walkers, the producers, and idle warps.
__device__ void walk_phase(const uint4* rec, const Ring& rg, const uint16_t* keys, uint16_t* rows, int T, int* ne,
                           int* nn, uint32_t* state) {
  const int warp = threadIdx.x >> 5;
  if (warp < rg.walkers) {
    const int col = warp * 32 + (threadIdx.x & 31);
    const uint32_t x = walk_lane(rec, rg, col, col < rg.L, T);
    if (col < rg.L) *state = x;
  } else if (is_producer(warp, rg.walkers)) {
    int pw = 0;
    for (int w = rg.walkers; w < warp; ++w) pw += is_producer(w, rg.walkers);
    produce(rg, keys, rows, T, pw, ne, nn);
  }
}

// Warp 0: exclusive offsets of L lane counts; returns the total in off[L].
__device__ void lane_offsets(const int* cnt, int* off, int L) {
  const int lane = threadIdx.x & 31;
  const int chunk = (L + 31) / 32;
  const int lo = min(L, lane * chunk), hi = min(L, lo + chunk);
  int run = 0;
  for (int l = lo; l < hi; ++l) run += cnt[l];
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int acc = incl - run;
  for (int l = lo; l < hi; ++l) {
    off[l] = acc;
    acc += cnt[l];
  }
  if (lane == 31) off[L] = incl;
}

// Block-wide: word i of lane l's row goes to out[off[l] + i] if i < cnt[l]
// (emitted), else to out[nw + l * T - off[l] + T - 1 - i] (the non-emitted
// ones were stored from the row's end).  A warp takes a segment of a row,
// each thread kPackPairs word pairs of it (4-byte loads, all in flight),
// so loads and stores of a warp are contiguous.
__device__ void pack_words(const uint16_t* rows, const int* cnt, const int* off, int L, int T, int16_t* out) {
  constexpr int kSegPairs = 32 * kPackPairs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = off[L], pairs = T / 2, segs = (pairs + kSegPairs - 1) / kSegPairs;
  for (int item = warp; item < L * segs; item += kWarps) {
    const int l = item / segs, k0 = (item - l * segs) * kSegPairs + lane;
    const int c = cnt[l], o = off[l], back = nw + l * T - o + T - 1;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(rows + l * T);
    uint32_t v[kPackPairs];
#pragma unroll
    for (int u = 0; u < kPackPairs; ++u) v[u] = row[min(k0 + 32 * u, pairs - 1)];
#pragma unroll
    for (int u = 0; u < kPackPairs; ++u) {
      const int i = 2 * (k0 + 32 * u);
      if (i < T) {
        out[i < c ? o + i : back - i] = (int16_t)(v[u] & 0xFFFFu);
        out[i + 1 < c ? o + i + 1 : back - i - 1] = (int16_t)(v[u] >> 16);
      }
    }
  }
}

__device__ void residual_block(const Params& p, int b, unsigned char* smem, int* hist, int* freq, uint32_t* cum,
                               int* lane_cnt, int* lane_off) {
  __shared__ int warp_esc[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = p.l_res, T = p.t_res, total = L * T, hw = p.hw;
  const int32_t* q = p.q + (int64_t)b * hw;
  const int n = min(max(p.stream_len[b], 0), hw);
  int64_t* esc = p.r_esc + (int64_t)b * kEscCap;
  uint16_t* keys = p.keys + (int64_t)b * total;
  uint16_t* rows = p.rows + (int64_t)b * total;
  int64_t* stamps = (p.stamps != nullptr && b == 0) ? p.stamps : nullptr;
  uint32_t* own = reinterpret_cast<uint32_t*>(smem);  // [ctx * kSmallSyms + sym][thread]
  uint32_t* esc_list = reinterpret_cast<uint32_t*>(smem + kOwnBytes);
  stamp(stamps);
  for (int i = tid; i < kCtx * kSmallSyms * kThreads; i += kThreads) own[i] = 0u;
  for (int i = tid; i < kKeys; i += kThreads) hist[i] = 0;
  __syncthreads();

  // 1. warp w keys the positions [lo, hi) of the L x T steps, a thread
  // kVec consecutive ones of one lane a round (one 16-byte load where q's
  // rows allow, the two before them from the lane before), and lists its
  // first kEscCap escapes in stream order.  A live key of a symbol below
  // kSmallSyms is counted in the thread's own counter (most keys of a warp
  // are equal, and shared atomics on one address serialize), any other with
  // a shared atomic.
  {
    constexpr int kStride = 32 * kVec;  // positions a warp keys a round
    const int per = (total + kThreads * kVec - 1) / (kThreads * kVec) * kStride;
    const int lo = min(total, warp * per), hi = min(total, lo + per);  // multiples of kVec, as is T
    uint32_t* list = esc_list + warp * kEscCap;
    Cursor at(lo + kVec * lane, kStride, T);  // (lane, step) of the thread's first position of a round
    const bool vec = hw % kVec == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;  // uniform over the block
    // q before the warp's first position; before position 0, q[0] itself (its delta is 0).
    int carry1 = lo == 0 ? q[0] : lo <= hw ? q[lo - 1] : 0, carry2 = lo <= 1 ? q[0] : lo - 2 < hw ? q[lo - 2] : 0;
    int seen = 0;
    for (int base = lo; base < hi; base += kStride * kRounds) {
      int4 v[kRounds];  // q at the thread's positions p0 .. p0 + 3 (0 past hw)
      int t0[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int p0 = base + kStride * u + kVec * lane;
        if (vec) {
          v[u] = p0 < hw ? *reinterpret_cast<const int4*>(q + p0) : make_int4(0, 0, 0, 0);
        } else {
          v[u] = make_int4(q[min(p0, hw - 1)], q[min(p0 + 1, hw - 1)], q[min(p0 + 2, hw - 1)], q[min(p0 + 3, hw - 1)]);
        }
        t0[u] = at.t;
        at.advance();
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int p0 = base + kStride * u + kVec * lane;
        const int prev1 = __shfl_up_sync(0xffffffffu, v[u].w, 1), prev2 = __shfl_up_sync(0xffffffffu, v[u].z, 1);
        const uint32_t qv[kVec + 2] = {(uint32_t)(lane == 0 ? carry2 : prev2), (uint32_t)(lane == 0 ? carry1 : prev1),
                                       (uint32_t)v[u].x, (uint32_t)v[u].y, (uint32_t)v[u].z, (uint32_t)v[u].w};
        carry1 = __shfl_sync(0xffffffffu, v[u].w, 31);
        carry2 = __shfl_sync(0xffffffffu, v[u].z, 31);
        // sym[k]: the symbol at p0 - 1 + k, which only a live position's key
        // reads (a live position's predecessor is live).
        uint32_t sym[kVec + 1], key[kVec];
        bool esc[kVec];
        const int live_n = min(hi, n) - p0;  // positions p0 + e with e < live_n are live
#pragma unroll
        for (int k = 0; k <= kVec; ++k) {
          const uint32_t zz = zigzag(qv[k + 1] - qv[k]);
          sym[k] = sym_of(zz);
          if (k > 0) esc[k - 1] = k - 1 < live_n && zz >= kEscape;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const bool live = e < live_n;
          const uint32_t ctx = e == 0 && t0[u] == 0 ? 0u : (uint32_t)zigzag_ctx(sym[e]);  // a lane's first step: context 0
          key[e] = live ? ctx * kAlphabet + sym[e + 1] : (uint32_t)kDead;
          const bool small = live && sym[e + 1] < kSmallSyms;
          own[(small ? ctx * kSmallSyms + sym[e + 1] : 0) * kThreads + tid] += small;
          if (live && !small) atomicAdd(&hist[key[e]], 1);  // a dead step's key (kDead) is never counted
        }
        if (p0 < hi)
          *reinterpret_cast<uint2*>(keys + p0) = make_uint2(__byte_perm(key[0], key[1], 0x5410), __byte_perm(key[2], key[3], 0x5410));
        // Escapes in stream order: the thread's own in order, after those of the lanes before it.
        const int mine_n = esc[0] + esc[1] + esc[2] + esc[3];
        if (__any_sync(0xffffffffu, mine_n > 0)) {
          int before = mine_n;
          for (int o = 1; o < 32; o <<= 1) {
            const int w = __shfl_up_sync(0xffffffffu, before, o);
            if (lane >= o) before += w;
          }
          const int all = __shfl_sync(0xffffffffu, before, 31);
          int rank = seen + before - mine_n;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            if (esc[e] && rank < kEscCap) list[rank] = zigzag(qv[e + 2] - qv[e + 1]);
            rank += esc[e];
          }
          seen += all;
        }
      }
    }
    if (lane == 0) warp_esc[warp] = seen;
  }
  __syncthreads();
  for (int k = warp; k < kCtx * kSmallSyms; k += kWarps) {
    int v = 0;
    for (int i = lane; i < kThreads; i += 32) v += (int)own[k * kThreads + i];
    v = warp_sum(v);
    if (lane == 0) hist[(k / kSmallSyms) * kAlphabet + k % kSmallSyms] = v;
  }
  {
    int before = 0, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_esc[w] : 0;
      all += warp_esc[w];
    }
    const int mine = min(warp_esc[warp], kEscCap);
    for (int i = lane; i < mine && before + i < kEscCap; i += 32) esc[before + i] = (int64_t)esc_list[warp * kEscCap + i];
    for (int i = min(all, kEscCap) + tid; i < kEscCap; i += kThreads) esc[i] = 0;
    if (tid == 0) {
      p.r_nesc[b] = all;
      p.r_q0[b] = q[0];
    }
  }
  __syncthreads();
  stamp(stamps ? stamps + 1 : nullptr);

  // 2. one warp per context row, then a record per key (and the dead step's).
  if (warp < kCtx)
    normalize_row(hist + warp * kAlphabet, freq + warp * kAlphabet, cum + warp * kAlphabet, kAlphabet,
                  p.r_freqs + ((int64_t)b * kCtx + warp) * kAlphabet);
  __syncthreads();
  uint4* rec = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < kRecords; i += kThreads) {
    const uint32_t k = key_of_slot(i);
    rec[i] = i < kKeys ? make_record(freq[k], cum[k]) : make_record(kM, 0);
  }
  __syncthreads();
  stamp(stamps ? stamps + 2 : nullptr);

  // 3. warp 0 walks the L lanes (its threads past L idle).
  const Ring rg = make_ring(smem + kRecBytes, L, true);
  uint32_t state = 0;
  walk_phase(rec, rg, keys, rows, T, lane_cnt, lane_off, &state);
  if (warp == 0 && lane < L) p.r_states[(int64_t)b * L + lane] = (int64_t)state;
  __syncthreads();
  if (tid < L) p.r_counts[(int64_t)b * L + tid] = lane_cnt[tid];
  stamp(stamps ? stamps + 3 : nullptr);

  // 4. pack.
  if (warp == 0) lane_offsets(lane_cnt, lane_off, L);
  __syncthreads();
  if (tid == 0) p.r_nw[b] = lane_off[L];
  pack_words(rows, lane_cnt, lane_off, L, T, p.r_words + (int64_t)b * total);
  __syncthreads();
  stamp(stamps ? stamps + 4 : nullptr);
}

__device__ void contour_block(const Params& p, int b, unsigned char* smem, int* hist, int* freq, uint32_t* cum,
                              int* lane_cnt, int* lane_off) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, W = p.W, T = p.t_cnt, total = H * T;
  const int32_t* bits = p.contour + (int64_t)b * H * W;
  const int64_t first = (int64_t)p.b_res * p.l_res * p.t_res + (int64_t)b * total;
  uint16_t* keys = p.keys + first;
  uint16_t* rows = p.rows + first;
  int64_t* stamps = (p.stamps != nullptr && b == 0) ? p.stamps + kPhases + 1 : nullptr;
  stamp(stamps);
  if (tid < 8) hist[tid] = 0;
  __syncthreads();

  // 1. keys and 8-bin histogram of all H x T steps, counted per thread
  // first (16-bit fields of two registers): warp w takes positions [lo, hi),
  // a thread kVec consecutive steps of one lane r a round; the key of step t
  // reads the plane at column t - r (its bit and the one above) and t - r - 1
  // (left).
  {
    constexpr int kStride = 32 * kVec;
    const int per = (total + kThreads * kVec - 1) / (kThreads * kVec) * kStride;
    const int lo = min(total, warp * per), hi = min(total, lo + per);
    Cursor at(lo + kVec * lane, kStride, T);  // (lane r, step t) of the thread's first position of a round
    uint64_t count[2] = {0, 0};  // keys 0-3 and 4-7, 16 bits each
    for (int base = lo; base < hi; base += kStride * kRounds) {
      int own_bit[kRounds][kVec + 1], above[kRounds][kVec];  // own_bit[k]: column c0 - 1 + k of row r
      int p0s[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        p0s[u] = base + kStride * u + kVec * lane;
        const int r = min(at.r, H - 1), c0 = at.t - at.r;
        const int32_t* row = bits + r * W;
#pragma unroll
        for (int k = 0; k <= kVec; ++k) {
          const int c = c0 - 1 + k;
          own_bit[u][k] = (c >= 0 && c < W) & (row[min(max(c, 0), W - 1)] != 0);
          if (k > 0) above[u][k - 1] = (r > 0 && c >= 0 && c < W) & (row[min(max(c, 0), W - 1) - (r > 0 ? W : 0)] != 0);
        }
        at.advance();
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        uint32_t key[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          key[e] = (2 * above[u][e] + own_bit[u][e]) * 2 + own_bit[u][e + 1];
          const uint64_t inc = p0s[u] < hi ? 1ull << ((key[e] & 3u) * 16) : 0ull;
          count[0] += key[e] < 4 ? inc : 0ull;
          count[1] += key[e] < 4 ? 0ull : inc;
        }
        if (p0s[u] < hi)
          *reinterpret_cast<uint2*>(keys + p0s[u]) =
              make_uint2(__byte_perm(key[0], key[1], 0x5410), __byte_perm(key[2], key[3], 0x5410));
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = warp_sum((int)((count[k >> 2] >> ((k & 3) * 16)) & 0xFFFFu));
      if (lane == 0 && s) atomicAdd(&hist[k], s);
    }
  }
  __syncthreads();
  stamp(stamps ? stamps + 1 : nullptr);

  // 2. one warp per context row of 2 symbols, then the 8 records.
  if (warp < 4) normalize_row(hist + warp * 2, freq + warp * 2, cum + warp * 2, 2, p.c_freqs + ((int64_t)b * 4 + warp) * 2);
  __syncthreads();
  uint4* rec = reinterpret_cast<uint4*>(smem);
  if (tid < 8) rec[tid] = make_record(freq[tid], cum[tid]);
  __syncthreads();
  stamp(stamps ? stamps + 2 : nullptr);

  // 3. the H lanes in passes of up to kPassRows, ceil(L / 32) warps walking a
  // pass's L lanes.
  for (int l0 = 0; l0 < H; l0 += kPassRows) {
    const Ring rg = make_ring(smem + kRecBytes, min(H - l0, kPassRows), false);
    uint32_t state = 0;
    walk_phase(rec, rg, keys + l0 * T, rows + l0 * T, T, lane_cnt + l0, lane_off + l0, &state);
    if (tid < rg.L) p.c_states[(int64_t)b * H + l0 + tid] = (int64_t)state;
    __syncthreads();
  }
  if (tid < H) p.c_counts[(int64_t)b * H + tid] = lane_cnt[tid];
  stamp(stamps ? stamps + 3 : nullptr);

  // 4. pack.
  if (warp == 0) lane_offsets(lane_cnt, lane_off, H);
  __syncthreads();
  if (tid == 0) p.c_nw[b] = lane_off[H];
  pack_words(rows, lane_cnt, lane_off, H, T, p.c_words + (int64_t)b * total);
  __syncthreads();
  stamp(stamps ? stamps + 4 : nullptr);
}

__global__ void __launch_bounds__(kThreads, 1) rans_encode_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int hist[kKeys];
  __shared__ int freq[kKeys];
  __shared__ uint32_t cum[kKeys];
  __shared__ int lane_cnt[kMaxRows];
  __shared__ int lane_off[kMaxRows + 1];
  if ((int)blockIdx.x < p.b_res)
    residual_block(p, blockIdx.x, smem, hist, freq, cum, lane_cnt, lane_off);
  else
    contour_block(p, blockIdx.x - p.b_res, smem, hist, freq, cum, lane_cnt, lane_off);
}

}  // namespace

extern "C" int rpcc_rans_encode_launch(
    const int32_t* q, const int32_t* stream_len, int b_res, int hw, int l_res, int t_res,
    const int32_t* contour, int b_cnt, int H, int W, int t_cnt,
    int16_t* r_words, int32_t* r_nw, int32_t* r_counts, int64_t* r_states, int32_t* r_freqs,
    int64_t* r_esc, int32_t* r_nesc, int32_t* r_q0,
    int16_t* c_words, int32_t* c_nw, int32_t* c_counts, int64_t* c_states, int32_t* c_freqs,
    uint16_t* keys, uint16_t* rows, int64_t* stamps, void* stream) {
  // A contour histogram thread counts kVec * ceil(H * T / (kThreads * kVec))
  // steps in 16-bit fields.
  const int64_t cnt_steps = ((int64_t)H * t_cnt + kThreads * kVec - 1) / (kThreads * kVec) * kVec;
  if (b_res < 0 || b_cnt < 0 || b_res + b_cnt == 0 ||
      (b_cnt > 0 && (H < 1 || H > kMaxRows || W < 1 || t_cnt < W + H - 1 || t_cnt % kRun != 0 ||
                     cnt_steps > 65535)) ||
      (b_res > 0 && (hw < 1 || l_res < 1 || l_res > kMaxLanes || (l_res & (l_res - 1)) != 0 || t_res < kRun ||
                     (int64_t)l_res * t_res < hw || t_res % kRun != 0 || (int64_t)l_res * t_res >= INT_MAX / 2)))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};  // per device, once (setting it again is harmless)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(rans_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = true;
  }
  Params p{q, stream_len, b_res, hw, l_res, t_res, contour, b_cnt, H, W, t_cnt,
           r_words, r_nw, r_counts, r_states, r_freqs, r_esc, r_nesc, r_q0,
           c_words, c_nw, c_counts, c_states, c_freqs, keys, rows, stamps};
  rans_encode_kernel<<<b_res + b_cnt, kThreads, kSmemBytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
