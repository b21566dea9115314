// Interleaved-lane rANS kernels — native host implementation.
//
// Bit-exact to the jax kernels in rpcc_tpu/ops/rans.py (PROB_BITS=14,
// 32-bit state, 16-bit renormalized IO, encode walks symbols in reverse):
// lanes are fully independent at encode, so each lane runs as a tight
// sequential loop instead of a lockstep lax.scan — ~50x faster than the
// jax-on-CPU formulation on a 1-core host, where the entropy stage bounds
// end-to-end throughput.  OpenMP parallelizes over frames when cores exist.
//
// Decode context modes:
//   0: zigzag-magnitude buckets of the lane's own previous symbol
//      (edges 1,3,8 on |delta| = (sym+1)/2) — the residual-stream model;
//   1: wavefront bits — ctx = 2*prev[lane-1] + prev[lane]; lane l step t
//      depends on lane l-1 step t-1, so lane-major decode order is causal;
//   2: always context 0 (order-0 containers).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t PROB_BITS = 14;
constexpr uint32_t M = 1u << PROB_BITS;
constexpr uint32_t RANS_L = 1u << 16;

inline int zigzag_ctx(int32_t prev) {
    int32_t mag = (prev + 1) >> 1;
    return (mag >= 1) + (mag >= 3) + (mag >= 8);
}

// Bit-exact twin of rans_native.py::normalize_freqs (f32 arithmetic order
// preserved; np.argmax keeps the FIRST maximum), including its repair pass
// for pathological near-uniform histograms whose top symbol cannot absorb
// the negative correction (repair re-floors with 1 reserved per present
// symbol, so its correction is >= 0 and the table stays valid).
inline void normalize_freqs_row(const int64_t* cnt, int A, int32_t* f) {
    int64_t total64 = 0;
    int32_t a_pos = 0;
    for (int a = 0; a < A; a++) {
        total64 += cnt[a];
        if (cnt[a] > 0) a_pos++;
    }
    if (total64 < 1) total64 = 1;
    float scale = (float)M / (float)total64;
    int32_t sum = 0;
    for (int a = 0; a < A; a++) {
        int32_t v = (int32_t)floorf((float)cnt[a] * scale);
        if (cnt[a] > 0 && v == 0) v = 1;
        f[a] = v;
        sum += v;
    }
    int32_t delta = (int32_t)M - sum;
    int top = 0;
    for (int a = 1; a < A; a++)
        if (f[a] > f[top]) top = a;
    if (f[top] + delta >= 1) {
        f[top] += delta;
        return;
    }
    float scale2 = (float)((int32_t)M - a_pos) / (float)total64;
    sum = 0;
    for (int a = 0; a < A; a++) {
        int32_t v = (int32_t)floorf((float)cnt[a] * scale2);
        if (cnt[a] > 0) v += 1;
        f[a] = v;
        sum += v;
    }
    delta = (int32_t)M - sum;  // >= 0: sum(floor) <= M - a_pos
    top = 0;
    for (int a = 1; a < A; a++)
        if (f[a] > f[top]) top = a;
    f[top] += delta;
}

// Per-lane rANS encode (walks t descending), then compact the per-lane word
// runs front-to-back into `packed` (same order the python fancy-index pack
// produced: lane-major, within a lane in emission order).
inline void encode_lanes(const int32_t* sym, const int32_t* ctx, int L, int T,
                         const int32_t* freqs, const uint32_t* cums, int A,
                         uint16_t* words, int32_t* counts, uint32_t* states,
                         uint16_t* packed, int32_t* n_words_out,
                         int64_t n_live = -1) {
    for (int l = 0; l < L; l++) {
        const int32_t* s = sym + (size_t)l * T;
        const int32_t* cx = ctx + (size_t)l * T;
        uint16_t* w = words + (size_t)l * T;
        uint32_t x = RANS_L;
        int32_t cnt = 0;
        int32_t start;
        if (n_live < 0) {
            start = T;
        } else {
            int64_t v = n_live - (int64_t)l * T;
            start = (int32_t)((v < 0) ? 0 : (v > T ? T : v));
        }
        for (int t = start - 1; t >= 0; t--) {
            uint32_t f = (uint32_t)freqs[(size_t)cx[t] * A + s[t]];
            uint32_t c = cums[(size_t)cx[t] * A + s[t]];
            if ((x >> 18) >= f) {
                w[cnt++] = (uint16_t)(x & 0xFFFFu);
                x >>= 16;
            }
            x = (x / f) * M + c + (x % f);
        }
        counts[l] = cnt;
        states[l] = x;
    }
    int32_t total = 0;
    for (int l = 0; l < L; l++) {
        std::memcpy(packed + total, words + (size_t)l * T,
                    (size_t)counts[l] * sizeof(uint16_t));
        total += counts[l];
    }
    *n_words_out = total;
}

}  // namespace

extern "C" {

namespace {
inline int32_t live_of(int64_t n, int l, int T) {
    int64_t v = n - (int64_t)l * T;
    if (v < 0) v = 0;
    if (v > T) v = T;
    return (int32_t)v;
}
}  // namespace

// sym/ctx: (B, L, T) int32; freqs: (B, C, A) uint16; cums: (B, C, A) uint32.
// lens: (B,) live flat lengths, or nullptr to code everything (LIVE-AWARE
// lanes: positions >= lens[b] are never entropy-coded; the decoder must be
// given the same lens).  Outputs: words (B, L, T) u16 front-packed per
// lane, counts (B, L) i32, states (B, L) u32.
void rans_encode_ctx_batch(const int32_t* sym, const int32_t* ctx,
                           const uint16_t* freqs, const uint32_t* cums,
                           const int64_t* lens,
                           int B, int L, int T, int C, int A,
                           uint16_t* words, int32_t* counts, uint32_t* states) {
#pragma omp parallel for schedule(dynamic, 1)
    for (int b = 0; b < B; b++) {
        const int32_t* sb = sym + (size_t)b * L * T;
        const int32_t* cb = ctx + (size_t)b * L * T;
        const uint16_t* fb = freqs + (size_t)b * C * A;
        const uint32_t* qb = cums + (size_t)b * C * A;
        const int64_t n = lens ? lens[b] : (int64_t)L * T;
        for (int l = 0; l < L; l++) {
            const int32_t* s = sb + (size_t)l * T;
            const int32_t* cx = cb + (size_t)l * T;
            uint16_t* w = words + ((size_t)b * L + l) * T;
            uint32_t x = RANS_L;
            int32_t cnt = 0;
            for (int t = live_of(n, l, T) - 1; t >= 0; t--) {
                uint32_t f = fb[(size_t)cx[t] * A + s[t]];
                uint32_t c = qb[(size_t)cx[t] * A + s[t]];
                if ((x >> 18) >= f) {
                    w[cnt++] = (uint16_t)(x & 0xFFFFu);
                    x >>= 16;
                }
                x = (x / f) * M + c + (x % f);
            }
            counts[(size_t)b * L + l] = cnt;
            states[(size_t)b * L + l] = x;
        }
    }
}

// Serial per-lane decode body (the reference formulation) — kept as the
// fallback for lives that are not a non-increasing prefix (never produced
// by our containers, but the C ABI does not forbid it).
static void decode_lanes_serial(
    const uint16_t* words, const int32_t* counts, const uint32_t* states,
    const uint16_t* fq, const uint32_t* qb, const uint16_t* s2s,
    const int32_t* lives, int64_t base_lane,
    int L, int T, int A, int mode, int32_t* ob) {
    for (int l = 0; l < L; l++) {
        const uint16_t* w = words + (base_lane + l) * T;
        int32_t* out = ob + (size_t)l * T;
        const int32_t* above = l > 0 ? ob + (size_t)(l - 1) * T : nullptr;
        uint32_t x = states[base_lane + l];
        int32_t cur = counts[base_lane + l];
        int32_t prev = 0;
        int32_t live = lives ? lives[base_lane + l] : T;
        if (live > T) live = T;
        for (int t = 0; t < live; t++) {
            int cid = 0;
            if (t > 0) {
                if (mode == 0) {
                    cid = zigzag_ctx(prev);
                } else if (mode == 1) {
                    int32_t ab = above ? above[t - 1] : 0;
                    cid = 2 * ab + prev;
                }
            }
            uint32_t slot = x & (M - 1);
            int32_t s = s2s[(size_t)cid * M + slot];
            uint32_t f = fq[(size_t)cid * A + s];
            uint32_t c = qb[(size_t)cid * A + s];
            x = f * (x >> PROB_BITS) + slot - c;
            if (x < RANS_L) {
                cur -= 1;
                uint32_t wv = w[cur > 0 ? cur : 0];
                x = (x << 16) | wv;
            }
            out[t] = s;
            prev = s;
        }
    }
}

// words: (B, L, T) u16 front-packed; slot2sym: (B, C, M) u16.
// mode: 0 zigzag buckets, 1 wavefront bits, 2 always-ctx-0.
// sym_out: (B, L, T) int32, caller-zeroed (mode 1 reads lane l-1's output
// beyond its live range as 0, matching the numpy/jax twins).
// lives: (B, L) live symbols per lane (supports mixed-T batches decoded at
// a common T_max), or nullptr to decode everything.
//
// Each lane's state chain is sequential, but the LANES are independent
// (mode 0/2) or dependent only on the previous lane one step behind
// (mode 1) — so the hot loops here interleave all L lanes per time step
// (modes 0/2) or sweep anti-diagonals (mode 1).  On the 1-core host this
// hides the ~4-cycle multiply + table-load latency chain behind 32
// independent chains: measured 14 -> ~5 ns/symbol, bit-identical output
// (per-lane arithmetic order is unchanged).
void rans_decode_ctx_batch(const uint16_t* words, const int32_t* counts,
                           const uint32_t* states, const uint16_t* freqs,
                           const uint32_t* cums, const uint16_t* slot2sym,
                           const int32_t* lives,
                           int B, int L, int T, int C, int A, int mode,
                           int32_t* sym_out) {
#pragma omp parallel for schedule(dynamic, 1)
    for (int b = 0; b < B; b++) {
        const uint16_t* fq = freqs + (size_t)b * C * A;
        const uint32_t* qb = cums + (size_t)b * C * A;
        const uint16_t* s2s = slot2sym + (size_t)b * C * M;
        int32_t* ob = sym_out + (size_t)b * L * T;
        const int64_t base_lane = (int64_t)b * L;

        std::vector<uint32_t> x(L);
        std::vector<int32_t> cur(L), prev(L, 0), live(L);
        bool mono = true;
        for (int l = 0; l < L; l++) {
            x[l] = states[base_lane + l];
            cur[l] = counts[base_lane + l];
            int32_t lv = lives ? lives[base_lane + l] : T;
            if (lv > T) lv = T;
            if (lv < 0) lv = 0;
            live[l] = lv;
            if (l > 0 && lv > live[l - 1]) mono = false;
        }

        if (mode == 1) {
            // Wavefront ctx (2*above[t-1] + prev): lane l step t depends on
            // lane l-1 step t-1 — anti-diagonal sweep keeps every lane in
            // flight one step apart; within a diagonal the lanes are
            // independent.  A is 2 for every wavefront container, so the
            // symbol comes from one compare against cum[cid][1] instead of
            // the 32 KB/ctx slot table.
            const bool bits = (A == 2);
            for (int d = 0; d < L + T - 1; d++) {
                int lo = d - T + 1;
                if (lo < 0) lo = 0;
                int hi = d < L - 1 ? d : L - 1;
                for (int l = lo; l <= hi; l++) {
                    int t = d - l;
                    if (t >= live[l]) continue;
                    int cid = 0;
                    if (t > 0) {
                        int32_t ab = l > 0 ? ob[(size_t)(l - 1) * T + t - 1] : 0;
                        cid = 2 * ab + prev[l];
                    }
                    uint32_t xx = x[l];
                    uint32_t slot = xx & (M - 1);
                    int32_t s = bits ? (slot >= qb[(size_t)cid * A + 1])
                                     : s2s[(size_t)cid * M + slot];
                    uint32_t f = fq[(size_t)cid * A + s];
                    uint32_t c = qb[(size_t)cid * A + s];
                    xx = f * (xx >> PROB_BITS) + slot - c;
                    // Branched renorm on purpose: at ~2.2 coded bits/symbol
                    // a word is consumed only ~14% of steps, so the branch
                    // predicts well — the branchless cmov variant measured
                    // SLOWER (extra unconditional word load on the chain).
                    if (xx < RANS_L) {
                        int32_t cu = --cur[l];
                        uint32_t wv =
                            words[(base_lane + l) * T + (cu > 0 ? cu : 0)];
                        xx = (xx << 16) | wv;
                    }
                    x[l] = xx;
                    ob[(size_t)l * T + t] = s;
                    prev[l] = s;
                }
            }
            continue;
        }

        if (!mono) {
            // lives with a gap (shorter lane before a longer one) would
            // break the active-prefix trim below; our containers always lay
            // lanes out as clip(n - l*T, 0, T), but stay correct anyway.
            decode_lanes_serial(words, counts, states, fq, qb, s2s, lives,
                                base_lane, L, T, A, mode, ob);
            continue;
        }

        // Modes 0/2: lanes fully independent — interleave all of them per
        // time step; live lanes form a shrinking prefix.
        const bool zz = (mode == 0);
        int act = L;
        for (int t = 0;; t++) {
            while (act > 0 && t >= live[act - 1]) act--;
            if (act == 0) break;
            for (int l = 0; l < act; l++) {
                int cid = (zz && t > 0) ? zigzag_ctx(prev[l]) : 0;
                uint32_t xx = x[l];
                uint32_t slot = xx & (M - 1);
                int32_t s = s2s[(size_t)cid * M + slot];
                uint32_t f = fq[(size_t)cid * A + s];
                uint32_t c = qb[(size_t)cid * A + s];
                xx = f * (xx >> PROB_BITS) + slot - c;
                // branched renorm on purpose (see the wavefront loop)
                if (xx < RANS_L) {
                    int32_t cu = --cur[l];
                    uint32_t wv =
                        words[(base_lane + l) * T + (cu > 0 ? cu : 0)];
                    xx = (xx << 16) | wv;
                }
                x[l] = xx;
                ob[(size_t)l * T + t] = s;
                prev[l] = s;
            }
        }
    }
}

// Fully-fused residual-stream encode: raw integer arrays in, container
// pieces out.  Replaces the numpy pre-pass (zigzag delta, escape fold,
// context ids, joint histogram, normalization, word packing) that dominated
// the batch entropy cost on the 1-core host.
//
// q_ptrs[b] points at lens[b] elements of dtype dtypes[b] (0=i16, 1=u16,
// 2=i32).  Symbols are the zigzag of the first-difference with zz >=
// ESCAPE(A-1) folded to the escape symbol; lanes are live-aware: the
// histogram and the coded symbols cover only the LIVE prefix (tail padding
// is never modeled or coded), exactly as the numpy path with
// encode_streams_batch_ctx(ns=...).  esc_counts[b] = -1 signals
// escape-capacity overflow (caller falls back to the numpy path for that
// frame).
void rans_delta_encode_frames(
    const uint64_t* q_ptrs, const uint8_t* dtypes, const int64_t* lens,
    int B, int L, int T, int C, int A, int esc_cap,
    uint16_t* packed,      // (B, L*T) compacted words
    int32_t* n_words_out,  // (B,)
    int32_t* counts,       // (B, L)
    uint32_t* states,      // (B, L)
    int32_t* freqs_out,    // (B, C, A) normalized
    uint32_t* escapes,     // (B, esc_cap)
    int32_t* esc_counts,   // (B,)
    int64_t* q0s) {        // (B,)
    const int64_t LT = (int64_t)L * T;
    const int32_t ESC = A - 1;
#pragma omp parallel for schedule(dynamic, 1)
    for (int b = 0; b < B; b++) {
        std::vector<int32_t> sym((size_t)LT, 0);
        std::vector<int32_t> ctx((size_t)LT, 0);
        std::vector<uint16_t> words((size_t)LT);
        const int64_t n = lens[b];
        uint32_t* esc = escapes + (size_t)b * esc_cap;
        int32_t n_esc = 0;
        int64_t prev_q = 0;
        bool overflow = false;
        for (int64_t j = 0; j < n; j++) {
            int64_t qj;
            const void* p = (const void*)(uintptr_t)q_ptrs[b];
            if (dtypes[b] == 0) qj = ((const int16_t*)p)[j];
            else if (dtypes[b] == 1) qj = ((const uint16_t*)p)[j];
            else qj = ((const int32_t*)p)[j];
            int64_t d = (j == 0) ? 0 : qj - prev_q;
            prev_q = qj;
            int64_t zz = (d >= 0) ? 2 * d : -2 * d - 1;
            if (zz >= ESC) {
                if (n_esc < esc_cap) esc[n_esc] = (uint32_t)zz;
                else overflow = true;
                n_esc++;
                sym[j] = ESC;
            } else {
                sym[j] = (int32_t)zz;
            }
            if (j == 0) q0s[b] = qj;
        }
        if (n == 0) q0s[b] = 0;
        if (overflow) {
            esc_counts[b] = -1;
            n_words_out[b] = 0;
            continue;
        }
        esc_counts[b] = n_esc;
        // Context ids + joint histogram over the LIVE stream only
        // (live-aware lanes: padding is never modeled nor coded).
        std::vector<int64_t> hist((size_t)C * A, 0);
        for (int l = 0; l < L; l++) {
            int32_t prev = 0;
            const int64_t off = (int64_t)l * T;
            const int32_t live = live_of(n, l, T);
            for (int t = 0; t < live; t++) {
                int cid = (t == 0) ? 0 : zigzag_ctx(prev);
                int32_t s = sym[off + t];
                ctx[off + t] = cid;
                hist[(size_t)cid * A + s]++;
                prev = s;
            }
        }
        int32_t* fq = freqs_out + (size_t)b * C * A;
        std::vector<uint32_t> cums((size_t)C * A);
        for (int c = 0; c < C; c++) {
            normalize_freqs_row(hist.data() + (size_t)c * A, A, fq + (size_t)c * A);
            uint32_t acc = 0;
            for (int a = 0; a < A; a++) {
                cums[(size_t)c * A + a] = acc;
                acc += (uint32_t)fq[(size_t)c * A + a];
            }
        }
        encode_lanes(sym.data(), ctx.data(), L, T, fq, cums.data(), A,
                     words.data(), counts + (size_t)b * L,
                     states + (size_t)b * L, packed + (size_t)b * LT,
                     n_words_out + b, n);
    }
}

// Fully-fused contour bit-plane encode: packed (MSB-first) bit rows in,
// container pieces out.  Lane r is image row r delayed r steps (diagonal
// wavefront), ctx = 2*above + left, alphabet {0,1}, 4 contexts — exactly
// rans_codec._compress_bits_batch's layout.
void rans_contour_encode_frames(
    const uint8_t* packed_bits,  // (B, nbytes) np.packbits rows
    int B, int64_t nbytes, int H, int W, int T,
    uint16_t* packed,      // (B, H*T) compacted words
    int32_t* n_words_out,  // (B,)
    int32_t* counts,       // (B, H)
    uint32_t* states,      // (B, H)
    int32_t* freqs_out) {  // (B, 4, 2) normalized
    const int64_t HT = (int64_t)H * T;
#pragma omp parallel for schedule(dynamic, 1)
    for (int b = 0; b < B; b++) {
        const uint8_t* pb = packed_bits + (size_t)b * nbytes;
        std::vector<int32_t> sym((size_t)HT, 0);
        std::vector<int32_t> ctx((size_t)HT, 0);
        std::vector<uint16_t> words((size_t)HT);
        int64_t hist[4 * 2] = {0};
        for (int r = 0; r < H; r++) {
            const int64_t off = (int64_t)r * T;
            const int64_t aoff = off - T;  // lane above
            int32_t left = 0;
            for (int t = 0; t < T; t++) {
                int64_t c = (int64_t)t - r;
                int32_t s = 0;
                if (c >= 0 && c < W) {
                    int64_t i = (int64_t)r * W + c;
                    s = (pb[i >> 3] >> (7 - (i & 7))) & 1;
                }
                int32_t above = (r > 0 && t > 0) ? sym[aoff + t - 1] : 0;
                int cid = (t == 0) ? 0 : 2 * above + left;
                sym[off + t] = s;
                ctx[off + t] = cid;
                hist[cid * 2 + s]++;
                left = s;
            }
        }
        int32_t* fq = freqs_out + (size_t)b * 8;
        uint32_t cums[8];
        for (int c = 0; c < 4; c++) {
            normalize_freqs_row(hist + c * 2, 2, fq + c * 2);
            cums[c * 2] = 0;
            cums[c * 2 + 1] = (uint32_t)fq[c * 2];
        }
        encode_lanes(sym.data(), ctx.data(), H, T, fq, cums, 2, words.data(),
                     counts + (size_t)b * H, states + (size_t)b * H,
                     packed + (size_t)b * HT, n_words_out + b);
    }
}

// Finalize decoded delta containers: escape substitution + unzigzag +
// prefix-sum + dtype cast, per frame — replaces a ~1.6 ms/frame numpy
// post-pass (decompress_delta_batch tail) on the 1-core host.  sym is the
// (B, L, Tmax) output of rans_decode_ctx_batch; frame b's stream position
// j lives at lane j / Ts[b], offset j % Ts[b].  Escape substitution runs
// in stream order (matching zz[sym == ESCAPE] = escapes) and d[0] is
// forced to 0 after substitution, exactly like the numpy path.  Returns
// the number of frames whose decoded ESCAPE occurrences differ from their
// escape-list length — a corrupt/truncated container; the numpy path's
// boolean-mask assignment raises on the same mismatch, and the Python
// wrapper must raise too rather than return silently-garbage residuals.
int rans_delta_finalize_frames(
    const int32_t* sym, int B, int L, int Tmax, int A,
    const int32_t* Ts, const int64_t* ns, const int64_t* q0s,
    const uint64_t* esc_ptrs, const int32_t* esc_counts,
    const uint8_t* dtypes,   // 0=i16, 1=u16, 2=i32
    uint64_t* out_ptrs) {
  const int32_t ESC = A - 1;
  int bad = 0;
  for (int b = 0; b < B; ++b) {
    const int32_t T = Ts[b];
    const int64_t n = ns[b];
    const int32_t n_esc = esc_counts[b];
    if (n <= 0 || T <= 0) {
      if (n_esc > 0) ++bad;  // escapes for an empty stream: corrupt
      continue;
    }
    const int32_t* s = sym + (int64_t)b * L * Tmax;
    const uint32_t* esc = (const uint32_t*)esc_ptrs[b];
    int64_t ei = 0;
    int64_t seen = 0;
    int64_t q = q0s[b];
    const uint8_t dt = dtypes[b];
    int16_t* o16 = (int16_t*)out_ptrs[b];
    uint16_t* ou16 = (uint16_t*)out_ptrs[b];
    int32_t* o32 = (int32_t*)out_ptrs[b];
    int64_t j = 0;
    for (int32_t lane = 0; lane < L && j < n; ++lane) {
      const int32_t* sl = s + (int64_t)lane * Tmax;
      int64_t lim = n - (int64_t)lane * T;
      if (lim > T) lim = T;
      for (int64_t t = 0; t < lim; ++t, ++j) {
        int64_t zz = sl[t];
        if (zz == ESC) {
          ++seen;
          if (ei < n_esc) zz = (int64_t)esc[ei++];
        }
        int64_t d = (j == 0) ? 0 : ((zz >> 1) ^ -(zz & 1));
        q += d;
        if (dt == 0) o16[j] = (int16_t)q;
        else if (dt == 1) ou16[j] = (uint16_t)q;
        else o32[j] = (int32_t)q;
      }
    }
    if (seen != (int64_t)n_esc) ++bad;
  }
  return bad;
}

// Finalize decoded delta containers DIRECTLY into the i8+exception decode
// uplink wire view (i16 streams only): q8[j] = q if |q| <= 127 else -128,
// with (position, value) exception pairs, exactly the view
// BatchEngine._prepare_decode used to rebuild by materializing the full
// (B, HW) i16 stream and re-scanning it three times (~0.5 ms/frame of the
// 1-core decode budget).  exc positions/values beyond exc_cap are not
// stored but n_exc keeps counting, so the caller can detect overflow and
// fall back to the full-i16 path for that batch.  Returns the corrupt-
// escape frame count like rans_delta_finalize_frames.
int rans_delta_finalize_frames_i8(
    const int32_t* sym, int B, int L, int Tmax, int A,
    const int32_t* Ts, const int64_t* ns, const int64_t* q0s,
    const uint64_t* esc_ptrs, const int32_t* esc_counts,
    uint64_t* out8_ptrs,     // per-frame (>= n) int8 rows
    uint64_t* excpos_ptrs,   // per-frame (exc_cap,) int32, caller-prefilled
    uint64_t* excval_ptrs,   // per-frame (exc_cap,) int16, caller-zeroed
    int32_t exc_cap,
    int32_t* n_exc_out) {    // (B,)
  const int32_t ESC = A - 1;
  int bad = 0;
  for (int b = 0; b < B; ++b) {
    const int32_t T = Ts[b];
    const int64_t n = ns[b];
    const int32_t n_esc = esc_counts[b];
    n_exc_out[b] = 0;
    if (n <= 0 || T <= 0) {
      if (n_esc > 0) ++bad;  // escapes for an empty stream: corrupt
      continue;
    }
    const int32_t* s = sym + (int64_t)b * L * Tmax;
    const uint32_t* esc = (const uint32_t*)esc_ptrs[b];
    int64_t ei = 0;
    int64_t seen = 0;
    int64_t q = q0s[b];
    int8_t* o8 = (int8_t*)out8_ptrs[b];
    int32_t* xp = (int32_t*)excpos_ptrs[b];
    int16_t* xv = (int16_t*)excval_ptrs[b];
    int32_t nx = 0;
    int64_t j = 0;
    for (int32_t lane = 0; lane < L && j < n; ++lane) {
      const int32_t* sl = s + (int64_t)lane * Tmax;
      int64_t lim = n - (int64_t)lane * T;
      if (lim > T) lim = T;
      for (int64_t t = 0; t < lim; ++t, ++j) {
        int64_t zz = sl[t];
        if (zz == ESC) {
          ++seen;
          if (ei < n_esc) zz = (int64_t)esc[ei++];
        }
        int64_t d = (j == 0) ? 0 : ((zz >> 1) ^ -(zz & 1));
        q += d;
        const int16_t q16 = (int16_t)q;  // i16 stream semantics
        if (q16 > 127 || q16 < -127) {
          if (nx < exc_cap) {
            xp[nx] = (int32_t)j;
            xv[nx] = q16;
          }
          ++nx;
          o8[j] = -128;
        } else {
          o8[j] = (int8_t)q16;
        }
      }
    }
    n_exc_out[b] = nx;
    if (seen != (int64_t)n_esc) ++bad;
  }
  return bad;
}

// De-skew wavefront-decoded contour symbols and packbits MSB-first over
// the FLAT (H*W) bit stream (np.packbits semantics — bytes may span row
// boundaries when W % 8 != 0; the tail byte is zero-padded).  Bit (r, c)
// of the plane lives at sym[r, c + r] (the encoder shears rows by r).
// Replaces the per-frame numpy gather + packbits.
void rans_contour_finalize_frames(
    const int32_t* sym, int B, int H, int W, int T,
    uint8_t* out) {  // (B, ceil(H*W/8))
  const int64_t nb = ((int64_t)H * W + 7) / 8;
  for (int b = 0; b < B; ++b) {
    const int32_t* s = sym + (int64_t)b * H * T;
    uint8_t* o = out + (int64_t)b * nb;
    uint32_t acc = 0;
    int nacc = 0;
    int64_t k = 0;
    for (int32_t r = 0; r < H; ++r) {
      const int32_t* row = s + (int64_t)r * T + r;  // skew offset
      for (int32_t c = 0; c < W; ++c) {
        acc = (acc << 1) | (uint32_t)(row[c] & 1);
        if (++nacc == 8) {
          o[k++] = (uint8_t)acc;
          acc = 0;
          nacc = 0;
        }
      }
    }
    if (nacc) o[k++] = (uint8_t)(acc << (8 - nacc));
  }
}

}  // extern "C"
