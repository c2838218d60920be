// The UPEM move function of one block instance, run by every thread of a
// CTA: the body of K4 (upem_moves.cu), also run inside K6's climb kernel
// (upem_eval.cu) between its evaluations. One source for both.
//
// Replaces floria_tpu/kernels/upem_batch.py `_apply_moves_single` (:259):
// from (assign [R], diff [R, P], num_reads) it counts the live part sizes,
// forms every candidate move (r -> j) with gain = diff[r, a_r] - diff[r, j],
// orders the valid ones by jnp.argsort(where(valid, -gain, inf),
// stable=True), and walks them with a running part-size check, stopping
// right after the applied move whose index passes the cap
// n_moves = n_valid // 10 (or n_valid // 3 + 1 when that is 0).
//   1. the assignment and the live part sizes, by shared-memory atomics
//      (integer, so the order does not matter);
//   2. every (r, j) tests valid = gain > 0, r < num_reads, j != a_r and
//      sizes[a_r] > 1, reading `diff` once;
//   3. the valid candidates are compacted by warp ballots, each warp taking
//      its base from one shared counter: their slots depend on the warps'
//      order, their sorted order does not (the keys are distinct);
//   4. a bitonic network sorts the n_valid (gain, k = r * P + j) pairs by
//      gain descending, then k ascending: the stable argsort's order over
//      the valid prefix (invalid keys are +inf and follow in generation
//      order, never visited). Every comparator is ascending, so pairs past
//      n_valid hold virtual +inf keys that no comparator moves, and only
//      n_valid entries are stored and sorted, not R * P. Gains are f64
//      differences of exact integers below 2^53, so they are exact whether
//      `diff` holds f64 (K4) or int64 quanta (the climb);
//   5. thread 0 walks the sorted list over the moved flags and part sizes.
// A negative part of a live row wraps to P + a, as the reference's and the
// host walk's indexing do; padding rows (r >= num_reads, -1 as the
// traceback leaves them) are never candidates and come back unchanged.

#pragma once

#include <stdint.h>

namespace floria_moves {

// (gain, k) sorts before (gain', k') when its gain is larger, or equal
// with an earlier generation index.
__device__ __forceinline__ void order_pair(double* gain, int32_t* cand,
                                           int lo, int hi) {
  const double ga = gain[lo], gb = gain[hi];
  const int ka = cand[lo], kb = cand[hi];
  if (gb > ga || (gb == ga && kb < ka)) {
    gain[lo] = gb;
    gain[hi] = ga;
    cand[lo] = kb;
    cand[hi] = ka;
  }
}

// as [R]: the assignment; dg [R, P]: the distances (DT = double or int64
// quanta); na [R]: the proposal (written; distinct from as); moved [R],
// gain and cand [R * (P - 1)]: work arrays; cur [P]: the part sizes;
// count: one int. Every pointer may be shared or device memory. Ends with
// a CTA barrier, after which na holds the proposal.
template <typename DT>
__device__ void move_function(const int32_t* as, const DT* dg, int nr, int R,
                              int P, int* cur, int* count, double* gain,
                              int32_t* cand, int32_t* na,
                              unsigned char* moved) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  for (int p = tid; p < P; p += nt) cur[p] = 0;
  if (tid == 0) *count = 0;
  __syncthreads();

  // 1. The assignment and the live part sizes.
  for (int r = tid; r < R; r += nt) {
    const int a = as[r];
    na[r] = a;
    moved[r] = 0;
    if (r < nr && a >= 0 && a < P) atomicAdd(&cur[a], 1);
  }
  __syncthreads();

  // 2-3. Valid candidates, compacted.
  const int RP = R * P;
  for (int e0 = 0; e0 < RP; e0 += nt) {
    const int e = e0 + tid;
    bool valid = false;
    double gn = 0.0;
    if (e < RP) {
      const int r = e / P;
      if (r < nr) {
        const int j = e - r * P;
        const int a = na[r];
        const int aw = min(max(a < 0 ? a + P : a, 0), P - 1);
        gn = (double)(dg[(long long)r * P + aw] - dg[e]);
        valid = gn > 0.0 && j != a && cur[aw] > 1;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, valid);
    if (m != 0u) {
      int base = 0;
      if (lane == 0) base = atomicAdd(count, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (valid) {
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        gain[pos] = gn;
        cand[pos] = e;
      }
    }
  }
  __syncthreads();
  const int n = *count;

  // 4. Sort the n candidates: gain descending, then k ascending.
  int lg_n = 0;
  while ((1 << lg_n) < n) ++lg_n;
  const int pairs = (1 << lg_n) >> 1;
  for (int ls = 1; ls <= lg_n; ++ls) {
    // Flip: i against its mirror in each block of 2^ls.
    const int lh = ls - 1;
    for (int t = tid; t < pairs; t += nt) {
      const int blk = t >> lh;
      const int off = t & ((1 << lh) - 1);
      const int lo = (blk << ls) + off;
      const int hi = (blk << ls) + (1 << ls) - 1 - off;
      if (hi < n) order_pair(gain, cand, lo, hi);
    }
    __syncthreads();
    // Half-cleaners at distances 2^(ls-2) .. 1.
    for (int ld = ls - 2; ld >= 0; --ld) {
      for (int t = tid; t < pairs; t += nt) {
        const int lo = ((t >> ld) << (ld + 1)) + (t & ((1 << ld) - 1));
        const int hi = lo + (1 << ld);
        if (hi < n) order_pair(gain, cand, lo, hi);
      }
      __syncthreads();
    }
  }

  // 5. The capped walk. A read moves at most once, so na[r] is still its
  // original part whenever moved[r] is 0.
  if (tid == 0) {
    int n_moves = n / 10;
    if (n_moves == 0) n_moves = n / 3 + 1;
    for (int k = 0; k < n; ++k) {
      const int idx = cand[k];
      const int r = idx / P;
      const int j = idx - r * P;
      if (moved[r]) continue;
      const int a = na[r];
      const int i = min(max(a < 0 ? a + P : a, 0), P - 1);
      if (cur[i] == 1) continue;
      na[r] = j;
      moved[r] = 1;
      cur[j] += 1;
      cur[i] -= 1;
      if (k > n_moves) break;
    }
  }
  __syncthreads();
}

}  // namespace floria_moves
