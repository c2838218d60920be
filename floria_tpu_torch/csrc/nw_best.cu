// K5: the device NW of SNP realignment, one thread per job, two alleles per
// DP on Hopper's DPX instructions.
//
// Replaces floria_tpu/kernels/realign.py `_nw_best_chunked` (:94) and the
// `_nw_scores` row scan it calls (:128): for each (read, SNP) job, the
// global affine-gap score of its 32-base query window against the
// reference window with each candidate allele at the centre, and the
// first allele of maximal score. Semantics are the reference's, not
// textbook Gotoh: match +1, mismatch -1, gap open -2 (including the first
// gap base), extend -1, sentinel NEG = -16384; Ix opens from M only, Iy
// from M and Ix; alleles a >= nal score NEG. Iy uses the sequential
// recurrence Iy[j] = max(max(M, Ix)[j-1] - 2, Iy[j-1] - 1), the form the
// reference's cummax trick evaluates in parallel.
//
// Two alleles per DP. The windows of alleles a and a + 1 differ only in
// column FLANK, so one DP runs both: every cell is one 32-bit register
// holding allele a in its low 16-bit lane and a + 1 in its high lane
// (alleles 0 and 1, then 2 and 3; an odd a_max leaves a dummy high lane,
// whose score is dropped). The reference runs this DP in int16
// (`_nw_scores`), and the lanes reproduce its integers exactly: every
// instruction below is a lane-wise 16-bit add followed by a signed max
// (__viaddmax_s16x2, one DPX instruction on sm_90), which wraps and never
// carries into the other lane, and no value it forms leaves int16's range:
// real cells lie in [-68, 32] (kernels/realign.py's note), the sentinel
// paths bottom out at NEG - 1 (Ix of row 0), and the largest offset
// subtracted is W = 32, so every intermediate lies in
// [NEG - 1 - W, 32 + W] = [-16417, 64], far inside [-32768, 32767].
//
// Each add-then-max of the recurrence is one __viaddmax_s16x2 once the
// gap penalties are folded into per-row and per-column offsets:
//   T[j] = Iy[j] + j       -> T[j] = max(mi[j-1] + (j - 2), T[j-1]),
//                             H[j] = max(mi[j], T[j] - j);
//   U[j] = Ix(row i)[j] + i -> mi[j] = max(U[j] - i, M[j]),
//                             U'[j] = max(M[j] + (i - 1), U[j]) (row i+1);
//   M[j] = H(row i-1)[j-1] + sub, as max(H + sub, -32768).
// A cell costs a compare and a select (the match score, shared by both
// lanes outside column FLANK) and five DPX instructions for two alleles,
// against ~11 integer instructions for one in the int32 form. H = max(M,
// Ix, Iy) needs no three-way max (__vimax3_s16x2): max(M, Ix) is formed
// anyway for the next column's Iy.
//
// State per thread, all in registers (the column loop is unrolled so every
// index is static): the previous row's packed H and this row's packed U,
// 33 columns each, and the 32 reference codes; T lives in one register
// along the row. ptxas (sm_90a) gives 126 registers and no spills, against
// 114 for the one-allele int32 form: half the row registers per allele,
// and the same 16 warps per SM at 128 threads a block.
//
// What bounds it on the H100: integer instruction throughput. At `ecoli2`'s
// partition (643,124 jobs, 2 alleles) that is 0.66 G packed DP cells of
// ~7 instructions; the per-job input is 24 bytes (16 packed query bytes,
// SNP row, allele count), read once and coalesced; the reference and
// allele tables (32 + A bytes per SNP) stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 32;
constexpr int FLANK = 16;
constexpr int NEG = -16384;
constexpr int GAP_OPEN = -2;
constexpr int GAP_EXTEND = -1;
constexpr int THREADS = 128;
constexpr uint32_t LANE_FLOOR = 0x80008000u;  // -32768 in both lanes

// v in both 16-bit lanes.
__host__ __device__ constexpr uint32_t both(int v) {
  return (uint32_t)(uint16_t)(int16_t)v * 0x00010001u;
}

constexpr uint32_t MATCH2 = both(1);
constexpr uint32_t MISMATCH2 = both(-1);

__device__ __forceinline__ int lane_lo(uint32_t v) {
  return (int)(int16_t)(uint16_t)(v & 0xFFFFu);
}

__device__ __forceinline__ int lane_hi(uint32_t v) {
  return (int)(int16_t)(uint16_t)(v >> 16);
}

// The NW scores of the query against the reference row with allele codes
// al_lo (low lane) and al_hi (high lane) at column FLANK; r[FLANK] unused.
__device__ __forceinline__ uint32_t nw_score_pair(uint64_t q_lo,
                                                  uint64_t q_hi,
                                                  const int (&r)[W],
                                                  int al_lo, int al_hi) {
  uint32_t H[W + 1];  // previous row's max(M, Ix, Iy)
  uint32_t U[W + 1];  // this row's Ix + i
  // Boundary row: M = [0, NEG...], Ix = NEG, Iy[j >= 1] = -2 - (j - 1);
  // row 0's Ix = max(NEG - 2, NEG - 1).
  H[0] = both(0);
#pragma unroll
  for (int j = 1; j <= W; ++j) {
    H[j] = both(GAP_OPEN + GAP_EXTEND * (j - 1));
    U[j] = both(NEG + GAP_EXTEND);
  }
#pragma unroll 1
  for (int i = 0; i < W; ++i) {
    const int qc = (int)((i < 16 ? q_lo >> (4 * i) : q_hi >> (4 * (i - 16)))
                         & 0xF);
    const uint32_t sub_al = (qc == al_lo ? 0x00000001u : 0x0000FFFFu)
                            | (qc == al_hi ? 0x00010000u : 0xFFFF0000u);
    const uint32_t minus_i = both(-i);
    const uint32_t i_minus_1 = both(i - 1);
    // Column 0: M = NEG, Ix = -2 - i, Iy = NEG (T[0] = NEG).
    const uint32_t ix0 = both(GAP_OPEN + GAP_EXTEND * i);
    uint32_t diag = H[0];
    uint32_t mi_prev = ix0;  // max(M, Ix) of the column to the left
    uint32_t t = both(NEG);
    H[0] = ix0;
#pragma unroll
    for (int j = 1; j <= W; ++j) {
      const uint32_t sub = j - 1 == FLANK
                               ? sub_al
                               : (qc == r[j - 1] ? MATCH2 : MISMATCH2);
      const uint32_t m = __viaddmax_s16x2(diag, sub, LANE_FLOOR);
      const uint32_t mi = __viaddmax_s16x2(U[j], minus_i, m);
      t = __viaddmax_s16x2(mi_prev, both(j - 2), t);
      diag = H[j];
      H[j] = __viaddmax_s16x2(t, both(-j), mi);
      U[j] = __viaddmax_s16x2(m, i_minus_1, U[j]);
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
  for (int a = 0; a < a_max; a += 2) {
    const bool has_hi = a + 1 < a_max;
    int sc_lo = NEG, sc_hi = NEG;
    if (a < na) {
      const int al_lo = al[a];
      const uint32_t h = nw_score_pair(qv.x, qv.y, r, al_lo,
                                       has_hi ? (int)al[a + 1] : al_lo);
      sc_lo = lane_lo(h);
      if (a + 1 < na) sc_hi = lane_hi(h);
    }
    // The first index of the maximum.
    if (scores != nullptr) scores[n * a_max + a] = sc_lo;
    if (a == 0 || sc_lo > best_sc) {
      best_sc = sc_lo;
      best_a = a;
    }
    if (has_hi) {
      if (scores != nullptr) scores[n * a_max + a + 1] = sc_hi;
      if (sc_hi > best_sc) {
        best_sc = sc_hi;
        best_a = a + 1;
      }
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
