// rANS encode of the residual stream and the contour plane on Hopper (sm_90a).
//
// Replaces the XLA program of rpcc_tpu/ops/rans_device.py
// (encode_residual_field_device and encode_contour_field_device, whose
// encode_field_device walks the lanes in one lax.scan of T dependent steps).
// That was no Pallas kernel, but in eager PyTorch its scan is ~10 launches a
// step, ~60,000 a batch, so the port needs one kernel.  Semantics, and the
// plain PyTorch version every output equals: rpcc_tpu_torch/ops/rans_device.py.
//
// What bounds it: not bytes (the inputs are ~0.6 MB a 64x2000 frame, ~0.2 us
// at 3.35 TB/s) but the chain of T dependent steps of each lane (4000 for the
// 64E residual, 2064 for its contour), each a compare, a shift and a u32
// divide-and-remainder by the symbol's frequency.
//
// Design: one launch per batch, one block per frame and field (blocks
// [0, B_res) code residual streams, blocks [B_res, B_res + B_cnt) contour
// planes).  A block
//   1. builds the symbols and contexts on the fly from q (or from the
//      contour bits and their wavefront shear) and histograms them in shared
//      memory with integer atomics (warp-aggregated over equal keys: exact
//      and deterministic); in the same ordered pass it compacts the escapes
//      in stream order by a block-wide ballot scan;
//   2. normalizes each context row with one warp, in f32 with __fdiv_rn /
//      __fmul_rn in the reference's order, ties of the argmax to the first
//      index, including the repair pass;
//   3. writes each position's packed (freq << 16 | cum) to a scratch array,
//      so a lane's walk reads one word a step, prefetched 8 steps ahead;
//   4. walks each lane in reverse with one thread (plain u32 / and %),
//      writing emitted words to the front of the lane's scratch row and the
//      others to its back;
//   5. packs: lane offsets by a warp scan, then a block-wide copy of the
//      emitted words lane-major and the non-emitted ones after them.
// No host sync: the kernel reads stream_len on the device.  A faster walk
// (the reference's reciprocal table via __umulhi, more lanes in flight per
// SM) is later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kM = 1u << 14;     // PROB_BITS = 14
constexpr uint32_t kRansL = 1u << 16;
constexpr int kLanes = 32;            // residual lanes
constexpr int kAlphabet = 512;
constexpr uint32_t kEscape = kAlphabet - 1;
constexpr int kCtx = 4;
constexpr int kEscCap = 512;
constexpr int kMaxRows = kThreads;    // contour lanes: one thread each

struct Params {
  const int32_t* q;           // (B_res, hw)
  const int32_t* stream_len;  // (B_res,)
  int b_res, hw, t_res;
  const int32_t* contour;     // (B_cnt, H, W)
  int b_cnt, H, W, t_cnt;
  int16_t* r_words;   // (B_res, 32 * t_res)
  int32_t* r_nw;      // (B_res,)
  int32_t* r_counts;  // (B_res, 32)
  int64_t* r_states;  // (B_res, 32)
  int32_t* r_freqs;   // (B_res, 4, 512)
  int64_t* r_esc;     // (B_res, 512)
  int32_t* r_nesc;    // (B_res,)
  int32_t* r_q0;      // (B_res,)
  int16_t* c_words;   // (B_cnt, H * t_cnt)
  int32_t* c_nw;      // (B_cnt,)
  int32_t* c_counts;  // (B_cnt, H)
  int64_t* c_states;  // (B_cnt, H)
  int32_t* c_freqs;   // (B_cnt, 4, 2)
  uint32_t* fc;       // scratch: residual frames' 32 * t_res, then contour frames' H * t_cnt
  uint16_t* rows;     // scratch words, same layout
  int64_t* stamps;    // null, or 6 %globaltimer values (ns) of block 0 at its phase bounds
};

__device__ __forceinline__ void stamp(const Params& p, int slot) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
    p.stamps[slot] = t;
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Zigzag value of the residual delta at stream position p: 0 at p == 0 and
// at or past n; the delta wraps as an int32, as in the reference.
__device__ __forceinline__ uint32_t zigzag_at(const int32_t* q, int64_t p, int64_t n) {
  if (p <= 0 || p >= n) return 0u;
  uint32_t d = (uint32_t)q[p] - (uint32_t)q[p - 1];
  return ((int32_t)d >= 0) ? (d << 1) : ((~d << 1) | 1u);
}

__device__ __forceinline__ uint32_t sym_of(uint32_t zz) { return zz >= kEscape ? kEscape : zz; }

__device__ __forceinline__ int zigzag_ctx(uint32_t prev) {
  uint32_t mag = (prev + 1) >> 1;
  return (mag >= 1) + (mag >= 3) + (mag >= 8);
}

// Joint (ctx, symbol) key of live residual position p (lane-local step t).
__device__ __forceinline__ int residual_key(const int32_t* q, int64_t p, int t, int64_t n, uint32_t* zz_out) {
  uint32_t zz = zigzag_at(q, p, n);
  *zz_out = zz;
  int c = (t == 0) ? 0 : zigzag_ctx(sym_of(zigzag_at(q, p - 1, n)));
  return c * kAlphabet + (int)sym_of(zz);
}

// Contour bit of lane r at step t of the wavefront (row r delayed r steps).
__device__ __forceinline__ int shear_bit(const int32_t* bits, int r, int t, int W) {
  int c = t - r;
  return (c >= 0 && c < W) ? (bits[(int64_t)r * W + c] != 0) : 0;
}

__device__ __forceinline__ int contour_key(const int32_t* bits, int r, int t, int W) {
  int s = shear_bit(bits, r, t, W);
  if (t == 0) return s;
  int left = shear_bit(bits, r, t - 1, W);
  int above = r > 0 ? shear_bit(bits, r - 1, t - 1, W) : 0;
  return (2 * above + left) * 2 + s;
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

// One rANS step in reverse: renormalize (emit the low 16 bits while x >=
// f * 2^18), then x = (x / f) * M + c + x % f.
__device__ __forceinline__ void rans_step(uint32_t v, uint32_t& x, uint16_t* row, int T, int& ne, int& nn) {
  const uint32_t f = v >> 16, c = v & 0xFFFFu;
  const uint16_t w = (uint16_t)(x & 0xFFFFu);
  if ((x >> 18) >= f) {
    row[ne++] = w;
    x >>= 16;
  } else {
    row[T - 1 - nn++] = w;
  }
  const uint32_t qd = x / f;
  x = qd * kM + c + (x - qd * f);
}

// One lane's walk over its `live` coded steps of `fc`.  The T - live dead
// steps come first in emission order with x == RANS_L, so their words are 0.
__device__ void walk_lane(const uint32_t* fc, int live, int T, uint16_t* row, int* count, uint32_t* state) {
  uint32_t x = kRansL;
  int ne = 0, nn = T - live;
  for (int t = live; t < T; ++t) row[t] = 0;
  int t = live - 1;
  for (; t >= 7; t -= 8) {
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = fc[t - k];
#pragma unroll
    for (int k = 0; k < 8; ++k) rans_step(v[k], x, row, T, ne, nn);
  }
  for (; t >= 0; --t) rans_step(fc[t], x, row, T, ne, nn);
  *count = ne;
  *state = x;
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

// Block-wide: the emitted words lane-major, then the non-emitted ones.
__device__ void pack_words(const uint16_t* rows, const int* cnt, const int* off, int L, int T, int16_t* out) {
  const int nw = off[L];
  const int64_t total = (int64_t)L * T;
  for (int64_t s = threadIdx.x; s < total; s += kThreads) {
    const int l = (int)(s / T), i = (int)(s - (int64_t)l * T);
    const uint16_t* row = rows + (int64_t)l * T;
    const int c = cnt[l];
    if (i < c) {
      out[off[l] + i] = (int16_t)row[i];
    } else {
      const int j = i - c;
      out[(int64_t)nw + (int64_t)l * T - off[l] + j] = (int16_t)row[T - 1 - j];
    }
  }
}

__device__ void residual_block(const Params& p, int b, int* hist, int* freq, uint32_t* cum, int* lane_cnt, int* lane_off) {
  __shared__ int warp_esc[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.t_res;
  const int hw = p.hw;
  const int32_t* q = p.q + (int64_t)b * hw;
  const int64_t n = min(max((int64_t)p.stream_len[b], (int64_t)0), (int64_t)hw);
  int64_t* esc = p.r_esc + (int64_t)b * kEscCap;
  uint32_t* fc = p.fc + (int64_t)b * kLanes * T;
  uint16_t* rows = p.rows + (int64_t)b * kLanes * T;
  stamp(p, 0);
  for (int i = tid; i < kCtx * kAlphabet; i += kThreads) hist[i] = 0;
  __syncthreads();

  // 1. histogram of the live positions + escapes in stream order.
  int esc_seen = 0;  // uniform over the block
  for (int64_t base = 0; base < n; base += kThreads) {
    const int64_t pos = base + tid;
    const bool live = pos < n;
    const unsigned live_mask = __ballot_sync(0xffffffffu, live);
    bool is_esc = false;
    uint32_t zz = 0;
    if (live) {
      const int key = residual_key(q, pos, (int)(pos % T), n, &zz);
      is_esc = zz >= kEscape;
      const unsigned peers = __match_any_sync(live_mask, key);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[key], __popc(peers));
    }
    const int here = __syncthreads_count(is_esc);
    if (here) {
      const unsigned ball = __ballot_sync(0xffffffffu, is_esc);
      if (lane == 0) warp_esc[warp] = __popc(ball);
      __syncthreads();
      int rank = esc_seen + __popc(ball & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) rank += warp_esc[w];
      if (is_esc && rank < kEscCap) esc[rank] = (int64_t)zz;
      esc_seen += here;
      __syncthreads();
    }
  }
  for (int i = min(esc_seen, kEscCap) + tid; i < kEscCap; i += kThreads) esc[i] = 0;
  if (tid == 0) {
    p.r_nesc[b] = esc_seen;
    p.r_q0[b] = q[0];
  }
  __syncthreads();
  stamp(p, 1);

  // 2. one warp per context row.
  if (warp < kCtx)
    normalize_row(hist + warp * kAlphabet, freq + warp * kAlphabet, cum + warp * kAlphabet, kAlphabet,
                  p.r_freqs + ((int64_t)b * kCtx + warp) * kAlphabet);
  __syncthreads();
  stamp(p, 2);

  // 3. (freq << 16 | cum) of every live position.
  for (int64_t pos = tid; pos < n; pos += kThreads) {
    uint32_t zz;
    const int key = residual_key(q, pos, (int)(pos % T), n, &zz);
    fc[pos] = ((uint32_t)freq[key] << 16) | cum[key];
  }
  __syncthreads();
  stamp(p, 3);

  // 4. one thread per lane.
  if (tid < kLanes) {
    const int live = (int)min(max(n - (int64_t)tid * T, (int64_t)0), (int64_t)T);
    int count;
    uint32_t state;
    walk_lane(fc + (int64_t)tid * T, live, T, rows + (int64_t)tid * T, &count, &state);
    lane_cnt[tid] = count;
    p.r_counts[(int64_t)b * kLanes + tid] = count;
    p.r_states[(int64_t)b * kLanes + tid] = (int64_t)state;
  }
  __syncthreads();
  stamp(p, 4);

  // 5. pack.
  if (warp == 0) lane_offsets(lane_cnt, lane_off, kLanes);
  __syncthreads();
  if (tid == 0) p.r_nw[b] = lane_off[kLanes];
  pack_words(rows, lane_cnt, lane_off, kLanes, T, p.r_words + (int64_t)b * kLanes * T);
  __syncthreads();
  stamp(p, 5);
}

__device__ void contour_block(const Params& p, int b, int* hist, int* freq, uint32_t* cum, int* lane_cnt, int* lane_off) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, W = p.W, T = p.t_cnt;
  const int32_t* bits = p.contour + (int64_t)b * H * W;
  const int64_t base = (int64_t)p.b_res * kLanes * p.t_res + (int64_t)b * H * T;
  uint32_t* fc = p.fc + base;
  uint16_t* rows = p.rows + base;
  stamp(p, 0);
  if (tid < 8) hist[tid] = 0;
  __syncthreads();

  // 1. histogram of all H * T positions: 8 bins, counted per thread first.
  const int64_t total = (int64_t)H * T;
  int local[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int64_t pos = tid; pos < total; pos += kThreads) {
    const int r = (int)(pos / T), t = (int)(pos - (int64_t)r * T);
    const int key = contour_key(bits, r, t, W);
#pragma unroll
    for (int k = 0; k < 8; ++k) local[k] += key == k;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int s = warp_sum(local[k]);
    if (lane == 0 && s) atomicAdd(&hist[k], s);
  }
  __syncthreads();
  stamp(p, 1);

  // 2. one warp per context row of 2 symbols.
  if (warp < 4) normalize_row(hist + warp * 2, freq + warp * 2, cum + warp * 2, 2, p.c_freqs + ((int64_t)b * 4 + warp) * 2);
  __syncthreads();
  stamp(p, 2);

  // 3.
  for (int64_t pos = tid; pos < total; pos += kThreads) {
    const int r = (int)(pos / T), t = (int)(pos - (int64_t)r * T);
    const int key = contour_key(bits, r, t, W);
    fc[pos] = ((uint32_t)freq[key] << 16) | cum[key];
  }
  __syncthreads();
  stamp(p, 3);

  // 4. every lane codes all T steps.
  if (tid < H) {
    int count;
    uint32_t state;
    walk_lane(fc + (int64_t)tid * T, T, T, rows + (int64_t)tid * T, &count, &state);
    lane_cnt[tid] = count;
    p.c_counts[(int64_t)b * H + tid] = count;
    p.c_states[(int64_t)b * H + tid] = (int64_t)state;
  }
  __syncthreads();
  stamp(p, 4);

  // 5.
  if (warp == 0) lane_offsets(lane_cnt, lane_off, H);
  __syncthreads();
  if (tid == 0) p.c_nw[b] = lane_off[H];
  pack_words(rows, lane_cnt, lane_off, H, T, p.c_words + (int64_t)b * H * T);
  __syncthreads();
  stamp(p, 5);
}

__global__ void __launch_bounds__(kThreads) rans_encode_kernel(const Params p) {
  __shared__ int hist[kCtx * kAlphabet];
  __shared__ int freq[kCtx * kAlphabet];
  __shared__ uint32_t cum[kCtx * kAlphabet];
  __shared__ int lane_cnt[kMaxRows];
  __shared__ int lane_off[kMaxRows + 1];
  if ((int)blockIdx.x < p.b_res)
    residual_block(p, blockIdx.x, hist, freq, cum, lane_cnt, lane_off);
  else
    contour_block(p, blockIdx.x - p.b_res, hist, freq, cum, lane_cnt, lane_off);
}

}  // namespace

extern "C" int rpcc_rans_encode_launch(
    const int32_t* q, const int32_t* stream_len, int b_res, int hw, int t_res,
    const int32_t* contour, int b_cnt, int H, int W, int t_cnt,
    int16_t* r_words, int32_t* r_nw, int32_t* r_counts, int64_t* r_states, int32_t* r_freqs,
    int64_t* r_esc, int32_t* r_nesc, int32_t* r_q0,
    int16_t* c_words, int32_t* c_nw, int32_t* c_counts, int64_t* c_states, int32_t* c_freqs,
    uint32_t* fc, uint16_t* rows, int64_t* stamps, void* stream) {
  if (b_res < 0 || b_cnt < 0 || b_res + b_cnt == 0 || (b_cnt > 0 && (H < 1 || H > kMaxRows || W < 1)) ||
      (b_res > 0 && (hw < 1 || (int64_t)kLanes * t_res < hw)) || (b_cnt > 0 && t_cnt < W + H - 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, stream_len, b_res, hw, t_res, contour, b_cnt, H, W, t_cnt,
           r_words, r_nw, r_counts, r_states, r_freqs, r_esc, r_nesc, r_q0,
           c_words, c_nw, c_counts, c_states, c_freqs, fc, rows, stamps};
  rans_encode_kernel<<<b_res + b_cnt, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
