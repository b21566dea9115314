// Latencies of dependent operations on the card, for the chain floors of the
// rANS kernels (csrc/rans.cu's encode step, csrc/rans_decode.cu's decode
// steps).  Each probe is a chain of `steps` (rounded down to a multiple of
// kUnroll) operations, each reading the
// result of the one before, timed with clock64() by one thread (lane 0 of
// warp 0; the shuffle and the barrier probes run in all the threads they
// need); %globaltimer around the whole probe gives the SM clock it ran at.
// One block of 64 threads (2 warps), launched by
// rpcc_tpu_torch/utils/chain_probe.py.
//
// Probes (cycles per dependent operation, in this order in `out`):
//   0 lds16     ld.shared.u16 whose value is the next load's address
//   1 lds64     ld.shared.v2.u32, the first word the next address
//   2 ldg16     ld.global.cg.u16 of an L2-resident table (warmed first;
//               .cg skips L1) whose value is the next index, plus the one
//               IMAD.WIDE that forms the next address
//   3 imad      mad.lo.u32
//   4 imad_hi   mul.hi.u32
//   5 alu       add.u32 and xor.b32 in turns (IADD3, LOP3: two adds or two
//               xors in a row would fold into one three-input instruction)
//   6 shf       shr.b32 by a register amount (SHF)
//   7 shfl      __shfl_sync from the next lane, a whole warp
//   8 bar2      __syncthreads() over 2 warps, arriving together
//   9 lds16_w   ld.shared.u16 chains in all 32 lanes of a warp at random
//               slots of an 8,192-entry table (the decode's slot lookup, bank
//               conflicts included)
// then `steps`, the clock64() and %globaltimer values at the first probe's
// start and the last one's end.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Shared tables (32 KB; entries are shared addresses, so they stay below 64 KB):
constexpr int kWarpTable = 8192;  // u16 at offset 0: the warp probe's
constexpr int kTable16 = 4096;    // u16 at 16 KB
constexpr int kTable64 = 1024;    // {next, 0} records at 24 KB
constexpr int kSmem = kWarpTable * 2 + kTable16 * 2 + kTable64 * 8;
constexpr int kProbes = 10;
constexpr int kUnroll = 16;

__device__ __forceinline__ int64_t globaltimer() {
  int64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return t;
}

__device__ __forceinline__ uint32_t lcg(uint32_t i, uint32_t n) { return (i * 5u + 12345u) & (n - 1); }  // full period

__global__ void __launch_bounds__(64) chain_probe_kernel(const uint16_t* l2, int l2_n, int steps, int64_t* out,
                                                         uint32_t seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tw = reinterpret_cast<uint16_t*>(smem);
  uint16_t* t16 = tw + kWarpTable;
  uint2* t64 = reinterpret_cast<uint2*>(t16 + kTable16);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t b16 = base + kWarpTable * 2, b64 = b16 + kTable16 * 2;
  const int tid = threadIdx.x, lane = tid & 31;
  if (base + kSmem > 65536u) {  // an address would not fit a u16 entry
    if (tid == 0) out[0] = -1;
    return;
  }
  for (int i = tid; i < kWarpTable; i += blockDim.x)
    tw[i] = (uint16_t)(base + 2 * ((i * 2654435761u + seed) & (kWarpTable - 1)));
  for (int i = tid; i < kTable16; i += blockDim.x) t16[i] = (uint16_t)(b16 + 2 * lcg(i, kTable16));
  for (int i = tid; i < kTable64; i += blockDim.x) t64[i] = make_uint2(b64 + 8 * lcg(i, kTable64), 0u);
  // Warm the L2 table (and leave L1 out: .cg).
  uint32_t warm = 0;
  for (int i = tid; i < l2_n; i += blockDim.x) {
    uint16_t v;
    asm volatile("ld.global.cg.u16 %0, [%1];" : "=h"(v) : "l"(l2 + i));
    warm += v;
  }
  __syncthreads();
  const int rounds = steps / kUnroll;
  int64_t cyc[kProbes];
  int64_t g0 = 0, c0 = 0;
  if (tid == 0) {
    g0 = globaltimer();
    c0 = clock64();
    uint32_t a = t16[0];
    int64_t t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) asm volatile("ld.shared.u16 %0, [%0];" : "+r"(a) : : "memory");
    }
    cyc[0] = clock64() - t;
    uint32_t b = t64[0].x, z;
    t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) asm volatile("ld.shared.v2.u32 {%0, %1}, [%0];" : "+r"(b), "=r"(z) : : "memory");
    }
    cyc[1] = clock64() - t;
    uint32_t idx = 0;
    t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        uint16_t v;
        asm volatile("ld.global.cg.u16 %0, [%1];" : "=h"(v) : "l"(l2 + idx) : "memory");
        idx = v;
      }
    }
    cyc[2] = clock64() - t;
    uint32_t v = a ^ b ^ idx ^ warm, m = seed | 1u, c = seed >> 3;
    t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(v) : "r"(m), "r"(c));
    }
    cyc[3] = clock64() - t;
    t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) asm volatile("mul.hi.u32 %0, %0, %1;" : "+r"(v) : "r"(m | 0x80000000u));
    }
    cyc[4] = clock64() - t;
    t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; q += 2)
        asm volatile("add.u32 %0, %0, %1;\n\txor.b32 %0, %0, %2;" : "+r"(v) : "r"(c), "r"(m));
    }
    cyc[5] = clock64() - t;
    const uint32_t sh = seed >> 31;  // 0 at run time, unknown to the compiler
    t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) asm volatile("shr.b32 %0, %0, %1;" : "+r"(v) : "r"(sh));
    }
    cyc[6] = clock64() - t;
    out[kProbes + 5] = v;  // keeps the chains' results alive
  }
  __syncthreads();
  if (tid < 32) {
    uint32_t v = tid;
    const int64_t t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) v = __shfl_sync(0xffffffffu, v, (lane + 1) & 31);
    }
    if (tid == 0) {
      cyc[7] = clock64() - t;
      out[kProbes + 6] = v;
    }
  }
  __syncthreads();
  {
    const int64_t t = clock64();
    for (int r = 0; r < rounds * kUnroll; ++r) __syncthreads();
    if (tid == 0) cyc[8] = clock64() - t;
  }
  if (tid < 32) {
    uint32_t a = tw[(lane * 977) & (kWarpTable - 1)];
    const int64_t t = clock64();
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) asm volatile("ld.shared.u16 %0, [%0];" : "+r"(a) : : "memory");
    }
    const int64_t d = clock64() - t;
    a = __shfl_sync(0xffffffffu, a, 0);  // waits for every lane's last load
    if (tid == 0) {
      cyc[9] = d;
      out[kProbes + 7] = a;
    }
  }
  if (tid == 0) {
    const int64_t c1 = clock64(), g1 = globaltimer();
    for (int p = 0; p < kProbes; ++p) out[p] = cyc[p];
    out[kProbes] = (int64_t)rounds * kUnroll;
    out[kProbes + 1] = c0;
    out[kProbes + 2] = c1;
    out[kProbes + 3] = g0;
    out[kProbes + 4] = g1;
  }
}

}  // namespace

// Runs the probes in one block on `stream` (no synchronize): `l2` a device
// table of `l2_n` u16 indices (a power of two, each entry the next index),
// `out` kProbes + 8 int64 (see above).  Returns a cudaError_t.
extern "C" int rpcc_chain_probe_launch(const uint16_t* l2, int l2_n, int steps, int64_t* out, unsigned seed,
                                       void* stream) {
  if (l2_n < 1 || (l2_n & (l2_n - 1)) != 0 || steps < kUnroll) return (int)cudaErrorInvalidValue;
  chain_probe_kernel<<<1, 64, kSmem, (cudaStream_t)stream>>>(l2, l2_n, steps, out, seed);
  return (int)cudaGetLastError();
}
