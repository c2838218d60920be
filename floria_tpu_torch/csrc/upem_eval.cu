// K6: UPEM move evaluation, one CTA per block instance.
//
// Replaces floria_tpu/kernels/upem_batch.py `_eval_diff_score` (:50) and
// `_eval_mec` (:196), which the TPU runs once per hill-climb iteration of
// `_upem_optimize_device_jit` (:320) as batched MXU einsums over 13-bit
// weight planes, and the body of that climb's while_loop (:343-354) around
// the move function (K4). Three modes:
//   init (0): the distances diff [R, P] of every read to every part's
//             consensus and the phred MEC-epsilon score of `assign`
//             (local_clustering.rs:218-260); active = 1;
//   step (1): one iteration after K4 proposed `assign`: an inactive
//             instance returns at once; one whose proposal equals `best`
//             becomes inactive; otherwise the proposal is evaluated and
//             accepted (best, score and diff written) only if its score is
//             higher, else the instance becomes inactive;
//   mec  (2): the unit-weight (bases, errors) of `assign`, the ploidy-sweep
//             stopping statistics (get_mec_stats_epsilon_no_phred).
// The climb is launches only: K6 init, NUM_ITER_OPTIMIZE rounds of K4 and
// K6 step, K6 mec, with no host wait; converged instances cost one load of
// their flag per round.
//
// Exact integers throughout. A weight is an f32 multiple of 2^-26 in
// [0, 1], so its quanta w * 2^26 are an exact int64; counts and distances
// are int64 sums (any order), written as f64 (every value is below 2^53:
// a covered cell's weight counts at most once, and a dispatch holds at
// most 2^26 cells). epsq = rint(epsilon * 2^26), as the K1 wrapper's `_eps`
// and the plain version's torch.round compute it. The terms mirror the
// plain version (floria_tpu_torch/kernels/upem_batch.py `_eval_diff_score`,
// `_eval_mec`) term for term: a part is nonempty at a column when its
// largest allele count is > 0 (weights, not coverage); it has a key there
// when one of its reads covers the column (any allele value); the epsilon
// term of the score counts keyed columns whose largest count is at most
// one weight unit; assignments outside [0, P) contribute nothing; alleles
// >= A cover but count for no allele. The unit MEC sums uerr + eps * n in
// f64 in the plain version's order (exact: uerr <= R * S <= 2^26).
//
// What bounds it on the H100: bytes. An evaluation must read each cell's
// allele (1 B) and weight (4 B) once and write diff (8 B per read and
// part); its operations, ~(P + 2) per cell, are far below the card's rate.
// The design keeps every intermediate of an instance on chip:
//   1. column pass: each thread owns columns and sums, over all reads, the
//      weight quanta per (allele, part) and the reads per part of its
//      columns (no atomics: one owner per column); the reads' loads are
//      coalesced across the warp's columns;
//   2. the same thread turns each of its (part, column) pairs into its
//      error and epsilon terms and a byte mask (bit a: allele a's count is
//      below the largest; bit 7: the part is empty there), stored over the
//      coverage it no longer needs;
//   3. one block reduction gives the score; then a warp per read sums the
//      read's distance to up to 8 parts per sweep of its row, coalesced.
// The counts [A, P, S] int64 and the coverage/masks [P, S] int32 stay in
// shared memory when they fit the opt-in limit (227 KB on the H100: S up to
// 2048 at P = 5, A = 2); otherwise the same kernel keeps them in a device
// scratch the wrapper allocates (kShared = false). Pass 3 reads the cells a
// second time; fusing it with K4 into one launch per round is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PCHUNK = 8;            // parts per sweep of a read's row
constexpr long long ONE_Q = 1LL << 26;  // weight 1.0 in quanta
constexpr unsigned kEmpty = 0x80u;
constexpr int kStep = 1, kMec = 2;  // mode 0 is init

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// x, y, z summed over the CTA; every thread returns with the totals.
// Called once per launch (the partials are never rewritten).
__device__ __forceinline__ void block_sum3(long long& x, long long& y,
                                           long long& z,
                                           long long (*red)[WARPS]) {
  x = warp_sum(x);
  y = warp_sum(y);
  z = warp_sum(z);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][w] = x;
    red[1][w] = y;
    red[2][w] = z;
  }
  __syncthreads();
  x = y = z = 0;
  for (int i = 0; i < WARPS; ++i) {
    x += red[0][i];
    y += red[1][i];
    z += red[2][i];
  }
}

__device__ __forceinline__ long long quanta(float w) {
  return (long long)(w * 67108864.0f);  // exact: w is a multiple of 2^-26
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS) upem_eval_kernel(
    int mode,
    const int8_t* __restrict__ alleles,  // [G, R, S], -1 uncovered
    const float* __restrict__ weights,   // [G, R, S]; unread in mec mode
    const int32_t* __restrict__ assign,  // [G, R] assignment or proposal
    const float* __restrict__ epsilon,   // [G]
    int32_t* __restrict__ best,          // [G, R] step: in/out
    double* __restrict__ score,          // [G] init: out; step: in/out
    double* __restrict__ diff,           // [G, R, P] init: out; step: in/out
    unsigned char* __restrict__ active,  // [G] init: out; step: in/out
    double* __restrict__ mec,            // [G, 2] mec: out
    unsigned char* __restrict__ scratch,  // [G, stride] when !kShared
    long long stride, int R, int S, int P, int A) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_red[3][WARPS];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* as = assign + (long long)g * R;

  double old_score = 0.0;
  if (mode == kStep) {
    if (!active[g]) return;
    // Every thread reads the old score before any thread can write it.
    old_score = score[g];
    const int32_t* bs = best + (long long)g * R;
    int changed = 0;
    for (int r = tid; r < R; r += THREADS) changed |= as[r] != bs[r];
    if (!__syncthreads_or(changed)) {
      if (tid == 0) active[g] = 0;
      return;
    }
  }

  unsigned char* base = kShared ? smem : scratch + g * stride;
  long long* counts = reinterpret_cast<long long*>(base);        // [A, P, S]
  int* cov = reinterpret_cast<int*>(base + 8LL * A * P * S);     // [P, S]
  const long long cells = (long long)R * S;
  const int8_t* al = alleles + g * cells;
  const float* wt = weights + g * cells;
  const long long epsq = (long long)rint((double)epsilon[g] * 67108864.0);
  const bool unit = mode == kMec;

  // 1-2. Column pass: counts, then terms and masks, per owned column.
  long long err = 0, nlow = 0, bases = 0;
  for (int s = tid; s < S; s += THREADS) {
    for (int i = 0; i < A * P; ++i) counts[(long long)i * S + s] = 0;
    for (int p = 0; p < P; ++p) cov[p * S + s] = 0;
    for (int r = 0; r < R; ++r) {
      const int a = al[(long long)r * S + s];
      if (a < 0) continue;
      const int p = as[r];
      if (p < 0 || p >= P) continue;
      cov[p * S + s] += 1;
      if (a < A) {
        long long q = 1;
        if (!unit) q = quanta(wt[(long long)r * S + s]);
        counts[((long long)a * P + p) * S + s] += q;
      }
    }
    for (int p = 0; p < P; ++p) {
      long long maxc = 0, total = 0;
      for (int a = 0; a < A; ++a) {
        const long long c = counts[((long long)a * P + p) * S + s];
        maxc = c > maxc ? c : maxc;
        total += c;
      }
      if (unit) {
        if (total > 0) {
          bases += maxc;
          err += total - maxc;
          nlow += maxc <= 1;
        }
        continue;
      }
      unsigned m = maxc == 0 ? kEmpty : 0u;
      for (int a = 0; a < A; ++a)
        if (counts[((long long)a * P + p) * S + s] < maxc) m |= 1u << a;
      if (cov[p * S + s] > 0) {
        err += total - maxc;
        nlow += maxc <= ONE_Q;
      }
      cov[p * S + s] = (int)m;  // the mask from here on
    }
  }
  // The reduction's barrier also publishes every column's masks.
  block_sum3(err, nlow, bases, s_red);

  if (mode == kMec) {
    if (tid == 0) {
      const double eps_grid = (double)epsq / 67108864.0;
      mec[2 * g] = (double)bases;
      mec[2 * g + 1] = (double)err + eps_grid * (double)nlow;
    }
    return;
  }
  const double new_score = -(double)(err + epsq * nlow);
  if (mode == kStep) {
    if (!(new_score > old_score)) {
      if (tid == 0) active[g] = 0;
      return;
    }
    int32_t* bs = best + (long long)g * R;
    for (int r = tid; r < R; r += THREADS) bs[r] = as[r];
    if (tid == 0) score[g] = new_score;  // active stays 1
  } else if (tid == 0) {
    score[g] = new_score;
    active[g] = 1;
  }

  // 3. diff: a warp per read, up to PCHUNK parts per sweep of its row.
  const int warp = tid >> 5, lane = tid & 31;
  double* dg = diff + (long long)g * R * P;
  for (int r = warp; r < R; r += WARPS) {
    const int8_t* ar = al + (long long)r * S;
    const float* wr = wt + (long long)r * S;
    for (int p0 = 0; p0 < P; p0 += PCHUNK) {
      const int np = min(PCHUNK, P - p0);
      long long acc[PCHUNK];
#pragma unroll
      for (int j = 0; j < PCHUNK; ++j) acc[j] = 0;
      for (int s = lane; s < S; s += 32) {
        const int a = ar[s];
        if (a < 0) continue;
        const long long wq = a < A ? quanta(wr[s]) : 0;
#pragma unroll
        for (int j = 0; j < PCHUNK; ++j) {
          if (j < np) {
            const unsigned m = (unsigned)cov[(p0 + j) * S + s];
            if (m & kEmpty)
              acc[j] += epsq;
            else if (a < A && ((m >> a) & 1u))
              acc[j] += wq;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PCHUNK; ++j) {
        const long long v = warp_sum(acc[j]);
        if (lane == 0 && j < np) dg[(long long)r * P + p0 + j] = (double)v;
      }
    }
  }
}

}  // namespace

// `smem` bytes of dynamic shared memory hold the per-instance work arrays
// (8 * A * P * S + 4 * P * S bytes, rounded up) when `scratch` is null;
// otherwise they live at scratch + g * stride and smem is 0.
extern "C" int floria_upem_eval(int mode, const void* alleles,
                                const void* weights, const void* assign,
                                const void* epsilon, void* best, void* score,
                                void* diff, void* active, void* mec,
                                void* scratch, long long stride, int G, int R,
                                int S, int P, int A, int smem, void* stream) {
  if (G == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (scratch == nullptr) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          upem_eval_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    upem_eval_kernel<true><<<G, THREADS, smem, st>>>(
        mode, (const int8_t*)alleles, (const float*)weights,
        (const int32_t*)assign, (const float*)epsilon, (int32_t*)best,
        (double*)score, (double*)diff, (unsigned char*)active, (double*)mec,
        nullptr, 0, R, S, P, A);
  } else {
    upem_eval_kernel<false><<<G, THREADS, 0, st>>>(
        mode, (const int8_t*)alleles, (const float*)weights,
        (const int32_t*)assign, (const float*)epsilon, (int32_t*)best,
        (double*)score, (double*)diff, (unsigned char*)active, (double*)mec,
        (unsigned char*)scratch, stride, R, S, P, A);
  }
  return (int)cudaGetLastError();
}
