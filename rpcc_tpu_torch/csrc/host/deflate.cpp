// zlib-backed gzip/deflate field codec with a batched entry point.
//
// Native counterpart of the reference's gzip path (utils/compress_utils.py:
// 304-310).  The batched API compresses many fields in one call (OpenMP
// across buffers when built with -fopenmp) so a datalist runner's entropy
// stage is one C call per frame batch instead of Python-loop dispatch.

#include <cstdint>
#include <cstring>
#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

size_t deflate_bound(size_t n) { return compressBound(n) + 32; }

// Gzip-container deflate (mtime=0, OS=255 like python gzip with mtime=0).
// Returns compressed size or 0 on failure.
size_t gzip_compress_buf(const uint8_t* src, size_t src_len,
                         uint8_t* dst, size_t dst_cap, int level) {
    // zlib's avail_in/avail_out are uInt (32-bit): a >=4 GB buffer would
    // silently process only its low-32-bit prefix and report success.
    // Fields here are KB-MB; refuse loudly rather than truncate.
    if (src_len > 0xFFFFFFFFull || dst_cap > 0xFFFFFFFFull) return 0;
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16 /*gzip*/, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return 0;
    gz_header head;
    std::memset(&head, 0, sizeof(head));
    head.os = 255;
    deflateSetHeader(&zs, &head);
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = (uInt)src_len;
    zs.next_out = dst;
    zs.avail_out = (uInt)dst_cap;
    int rc = deflate(&zs, Z_FINISH);
    size_t out = zs.total_out;
    deflateEnd(&zs);
    return rc == Z_STREAM_END ? out : 0;
}

// Returns decompressed size or 0 on failure/overflow.
size_t gzip_decompress_buf(const uint8_t* src, size_t src_len,
                           uint8_t* dst, size_t dst_cap) {
    if (src_len > 0xFFFFFFFFull || dst_cap > 0xFFFFFFFFull) return 0;
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 32 /*auto gzip/zlib*/) != Z_OK) return 0;
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = (uInt)src_len;
    zs.next_out = dst;
    zs.avail_out = (uInt)dst_cap;
    int rc = inflate(&zs, Z_FINISH);
    size_t out = zs.total_out;
    inflateEnd(&zs);
    return rc == Z_STREAM_END ? out : 0;
}

// Batched: compress `count` buffers (concatenated in `src`, sizes in
// `src_lens`) into `dst` (each at stride `dst_stride`); writes per-buffer
// compressed sizes into `dst_lens`.  Parallel across buffers under OpenMP.
void gzip_compress_batch(const uint8_t* src, const size_t* src_offsets,
                         const size_t* src_lens, size_t count,
                         uint8_t* dst, size_t dst_stride, size_t* dst_lens,
                         int level) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (long i = 0; i < (long)count; i++) {
        dst_lens[i] = gzip_compress_buf(src + src_offsets[i], src_lens[i],
                                        dst + (size_t)i * dst_stride,
                                        dst_stride, level);
    }
}

}  // extern "C"
