// The block cache's padding on the card: each shape bucket's blocks arrive
// as their own cells only, back to back, and this kernel writes the
// bucket's padded [B, r_pad, s_pad] int8 alleles and uint8 quals from them.
//
// Replaces no TPU kernel. The JAX package pads its block cache on the host
// (floria_tpu/phase/local.py BlockDeviceCache) and uploads the padded
// arrays; the port used to do the same, and on `ecoli2` a third of every
// cache's bytes was padding written by the host and then copied. Now only
// the blocks' own cells cross (kernels/block_pad.py `stage`), and the
// padding is written here, where it costs device bandwidth only.
//
// Input layout (`staged`, one buffer per bucket): the alleles of every
// member, row-major [num_reads, num_sites] each, back to back from byte 0,
// then the members' quals in the same order from byte `cells`. `table` [B,
// 3] int64 holds each member's (offset of its first cell, num_reads,
// num_sites); the quals of a member start at `cells` + offset. The buffer
// holds SLACK readable bytes past its 2 * cells: a thread reads whole
// aligned words around its cells and masks what is not its own.
//
// Output: every cell of [B, r_pad, s_pad] is written once, the member's
// cell where r < num_reads and c < num_sites, else -1 (alleles) and 0
// (quals), so no memset runs before it.
//
// What bounds it on the H100: bytes. The outputs are written once (2 B a
// padded cell) and the staged cells read once (2 B a live cell): on an
// `ecoli2` cache 151.26 MB written and 100.89 MB read, ~75 us at 3.35
// TB/s. Design: one thread per 16 output bytes of one row, in the flat
// order of the outputs, so each thread stores one 16-byte vector to each
// output and a warp stores 512 contiguous bytes. A row of the staged
// buffer starts at any byte, so a thread loads the five aligned 32-bit
// words around its 16 source bytes (a warp's loads cover contiguous
// bytes, served from L1 after the first touch) and shifts them into place
// with funnel shifts. The member's table row is read by every thread of
// its rows and stays in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;  // output bytes per thread

// The 16 bytes at staged[o, o + 16), the bytes from `keep` on replaced by
// the byte `fill` (0xFF or 0x00 in all four lanes of `fill4`).
__device__ __forceinline__ uint4 load16(const uint32_t* __restrict__ words,
                                        long long o, int keep,
                                        uint32_t fill4) {
  const uint32_t* w = words + (o >> 2);
  const unsigned sh = (unsigned)(o & 3) * 8u;
  const uint32_t x0 = w[0], x1 = w[1], x2 = w[2], x3 = w[3], x4 = w[4];
  uint32_t y[4] = {__funnelshift_r(x0, x1, sh), __funnelshift_r(x1, x2, sh),
                   __funnelshift_r(x2, x3, sh), __funnelshift_r(x3, x4, sh)};
  if (keep < VEC) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kb = keep - 4 * k;  // bytes of word k that are live
      const uint32_t m = kb >= 4 ? 0xFFFFFFFFu
                         : kb <= 0 ? 0u
                                   : (1u << (8 * kb)) - 1u;
      y[k] = (y[k] & m) | (fill4 & ~m);
    }
  }
  return make_uint4(y[0], y[1], y[2], y[3]);
}

__global__ void __launch_bounds__(THREADS) block_pad_kernel(
    const uint8_t* __restrict__ staged,  // [2 * cells + SLACK]
    const long long* __restrict__ table, // [B, 3]
    long long cells, long long vecs, int r_pad, int s_pad,
    int8_t* __restrict__ alleles,        // [B, r_pad, s_pad] out
    uint8_t* __restrict__ quals) {       // [B, r_pad, s_pad] out
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= vecs) return;
  const int per_row = s_pad / VEC;
  const long long row = t / per_row;
  const int c0 = (int)(t - row * per_row) * VEC;
  const long long b = row / r_pad;
  const int r = (int)(row - b * r_pad);
  const long long off = table[3 * b];
  const long long nr = table[3 * b + 1];
  const long long ns = table[3 * b + 2];
  uint4 va = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  uint4 vq = make_uint4(0u, 0u, 0u, 0u);
  if (r < nr && c0 < ns) {
    const int keep = ns - c0 < VEC ? (int)(ns - c0) : VEC;
    const long long o = off + r * ns + c0;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(staged);
    va = load16(words, o, keep, 0xFFFFFFFFu);
    vq = load16(words, cells + o, keep, 0u);
  }
  reinterpret_cast<uint4*>(alleles)[t] = va;
  reinterpret_cast<uint4*>(quals)[t] = vq;
}

}  // namespace

extern "C" int floria_block_pad(const void* staged, const void* table,
                                long long cells, long long B, int r_pad,
                                int s_pad, void* alleles, void* quals,
                                void* stream) {
  const long long vecs = B * r_pad * (long long)(s_pad / VEC);
  if (vecs == 0) return 0;
  const long long blocks = (vecs + THREADS - 1) / THREADS;
  block_pad_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)staged, (const long long*)table, cells, vecs, r_pad,
      s_pad, (int8_t*)alleles, (uint8_t*)quals);
  return (int)cudaGetLastError();
}
