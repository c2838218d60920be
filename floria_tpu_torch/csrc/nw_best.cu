// K5: the device NW of SNP realignment, one thread per job.
//
// Replaces floria_tpu/kernels/realign.py `_nw_best_chunked` (:94) and the
// `_nw_scores` row scan it calls (:128): for each (read, SNP) job, the
// global affine-gap score of its 32-base query window against the
// reference window with each candidate allele at the centre, and the
// first allele of maximal score. Semantics are the reference's, not
// textbook Gotoh: match +1, mismatch -1, gap open -2 (including the first
// gap base), extend -1, sentinel NEG = -16384; Ix opens from M only, Iy
// from M and Ix; alleles a >= nal score NEG. The reference runs the DP in
// int16; int32 gives the same integers (kernels/realign.py's note shows
// no value leaves int16's range). Iy uses the sequential recurrence
// Iy[j] = max(max(M, Ix)[j-1] - 2, Iy[j-1] - 1), the form the reference's
// cummax trick evaluates in parallel.
//
// State per thread, all in registers (the column loop is unrolled so
// every index is static): the previous row's H = max(M, Ix, Iy) and the
// next row's Ix = max(M - 2, Ix - 1), 33 columns each, and the 32
// reference codes. Iy lives in one register along the row.
//
// What bounds it on the H100: integer instruction throughput. At `ecoli2`'s
// partition (643,124 jobs, 2 alleles) that is ~1.3 G DP cells of ~11
// integer ops each; the per-job input is 24 bytes (16 packed query
// bytes, SNP row, allele count), read once and coalesced; the reference
// and allele tables (32 + A bytes per SNP) stay in L2. Warp-per-job
// anti-diagonals, packed 16-bit compares (__vmaxs2) and pinned or async
// copies of the jobs are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 32;
constexpr int FLANK = 16;
constexpr int NEG = -16384;
constexpr int GAP_OPEN = -2;
constexpr int GAP_EXTEND = -1;
constexpr int THREADS = 128;

__device__ __forceinline__ int nw_score(uint64_t q_lo, uint64_t q_hi,
                                        const int (&r)[W]) {
  int H[W + 1];  // previous row's max(M, Ix, Iy)
  int X[W + 1];  // this row's Ix, from the previous row's M and Ix
  // Boundary row: M = [0, NEG...], Ix = NEG, Iy[j >= 1] = -2 - (j - 1).
  H[0] = 0;
#pragma unroll
  for (int j = 1; j <= W; ++j) {
    H[j] = GAP_OPEN + GAP_EXTEND * (j - 1);
    X[j] = NEG + GAP_EXTEND;  // max(NEG - 2, NEG - 1)
  }
#pragma unroll 1
  for (int i = 0; i < W; ++i) {
    const int qc = (int)((i < 16 ? q_lo >> (4 * i) : q_hi >> (4 * (i - 16)))
                         & 0xF);
    // Column 0: M = NEG, Ix = -2 - i, Iy = NEG.
    const int ix0 = GAP_OPEN + GAP_EXTEND * i;
    int diag = H[0];
    int mi_prev = ix0;  // max(M, Ix) of the column to the left
    int iy = NEG;
    H[0] = ix0;
#pragma unroll
    for (int j = 1; j <= W; ++j) {
      const int m = diag + (qc == r[j - 1] ? 1 : -1);
      const int ix = X[j];
      const int mi = max(m, ix);
      iy = max(mi_prev + GAP_OPEN, iy + GAP_EXTEND);
      diag = H[j];
      H[j] = max(mi, iy);
      X[j] = max(m + GAP_OPEN, ix + GAP_EXTEND);
      mi_prev = mi;
    }
  }
  return H[W];
}

__global__ void __launch_bounds__(THREADS) nw_best_kernel(
    const uint8_t* __restrict__ q_packed,  // [N, 16], even index = low nibble
    const int32_t* __restrict__ si,        // [N] SNP rows
    const int32_t* __restrict__ nal,       // [N] allele counts
    const uint8_t* __restrict__ ref_tab,   // [T, 32] codes
    const uint8_t* __restrict__ al_tab,    // [T, A] codes
    int8_t* __restrict__ best,             // [N] out
    int32_t* __restrict__ scores,          // [N, a_max] out, or null
    long long N, int A, int a_max) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const ulonglong2 qv = reinterpret_cast<const ulonglong2*>(q_packed)[n];
  const long long row = si[n];
  const int na = nal[n];
  const uint4* rp = reinterpret_cast<const uint4*>(ref_tab + row * W);
  const uint4 r0 = rp[0], r1 = rp[1];
  const uint32_t words[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  int r[W];
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = (words[j / 4] >> (8 * (j % 4))) & 0xFF;
  const uint8_t* al = al_tab + row * A;
  int best_a = 0;
  int best_sc = 0;
  for (int a = 0; a < a_max; ++a) {
    int sc = NEG;
    if (a < na) {
      r[FLANK] = al[a];
      sc = nw_score(qv.x, qv.y, r);
    }
    if (scores != nullptr) scores[n * a_max + a] = sc;
    if (a == 0 || sc > best_sc) {  // first index of the maximum
      best_sc = sc;
      best_a = a;
    }
  }
  best[n] = (int8_t)best_a;
}

}  // namespace

extern "C" int floria_nw_best(const void* q_packed, const void* si,
                              const void* nal, const void* ref_tab,
                              const void* al_tab, void* best, void* scores,
                              long long N, int A, int a_max, void* stream) {
  if (N == 0) return 0;
  const long long blocks = (N + THREADS - 1) / THREADS;
  nw_best_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q_packed, (const int32_t*)si, (const int32_t*)nal,
      (const uint8_t*)ref_tab, (const uint8_t*)al_tab, (int8_t*)best,
      (int32_t*)scores, N, A, a_max);
  return (int)cudaGetLastError();
}
