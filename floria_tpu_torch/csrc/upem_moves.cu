// K4: the whole UPEM move function, one CTA per block instance.
//
// Replaces floria_tpu/kernels/upem_batch.py `_apply_moves_single` (:259),
// which the TPU runs per instance under vmap (local_clustering.rs:292-358):
// from (assign [R], diff [R, P], num_reads) it counts the live part sizes,
// forms every candidate move (r -> j) with gain = diff[r, a_r] - diff[r, j],
// orders the valid ones by jnp.argsort(where(valid, -gain, inf),
// stable=True), and walks them with a running part-size check, stopping
// right after the applied move whose index passes the cap
// n_moves = n_valid // 10 (or n_valid // 3 + 1 when that is 0).
//
// What bounds it on the H100: latency, not bytes. The function's I/O is
// ~24 bytes per read at P = 2 (0.7 MB at the `ecoli2` dispatch, 0.2 us at
// 3.35 TB/s), but it is a chain of dependent steps per instance: a
// reduction, a compaction, a sort of n_valid keys and a serial walk. The
// design keeps every step of an instance inside one CTA (512 threads) and
// its state in shared memory, so the function is one launch with no
// device-memory round trip between steps:
//   1. coalesced load of the assignment; live part sizes by shared-memory
//      atomics (integer, so the order does not matter);
//   2. every (r, j) tests valid = gain > 0, r < num_reads, j != a_r and
//      sizes[a_r] > 1, reading `diff` once, coalesced;
//   3. the valid candidates are compacted by warp ballots, each warp taking
//      its base from one shared counter: their slots depend on the warps'
//      order, their sorted order does not (the keys are distinct);
//   4. a bitonic network sorts the n_valid (gain, k = r * P + j) pairs by
//      gain descending, then k ascending: the stable argsort's order over
//      the valid prefix (invalid keys are +inf and follow in generation
//      order, never visited). Every comparator is ascending, so pairs past
//      n_valid hold virtual +inf keys that no comparator moves, and only
//      n_valid entries are stored and sorted, not R * P. Gains are
//      compared as f64, which is exact;
//   5. thread 0 walks the sorted list over shared moved/part-size state;
//      the CTA then writes the proposal, coalesced.
// A negative part of a live row wraps to P + a, as the reference's and
// the host walk's indexing do; padding rows (r >= num_reads, -1 as the
// traceback leaves them) are never candidates and come back unchanged.
//
// An `active` mask (null: every instance active) lets the hill-climb run its
// fixed NUM_ITER_OPTIMIZE rounds on the card without a host wait: an
// inactive instance's CTA copies its assignment to the proposal and
// returns, so a converged instance proposes nothing (K6 then finds it
// unchanged) and costs one load of its flag per round.
//
// Shared memory per instance: 12 bytes per possible candidate (at most
// R * (P - 1)) plus 5 per read. When that exceeds the card's opt-in limit
// (227 KB on the H100; e.g. R > 4,600 at P = 5), the same kernel keeps
// those arrays in a device-memory scratch that the wrapper allocates
// (kShared = false); only the P part sizes stay in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

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

template <bool kShared>
__global__ void __launch_bounds__(THREADS) upem_moves_kernel(
    const int32_t* __restrict__ assign,     // [G, R]
    const double* __restrict__ diff,        // [G, R, P] quanta
    const int32_t* __restrict__ num_reads,  // [G]
    const unsigned char* __restrict__ active,  // [G] or null
    int32_t* __restrict__ proposal,         // [G, R] out
    unsigned char* __restrict__ scratch,    // [G, stride] when !kShared
    long long stride, int R, int P, int cap, int head) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (active != nullptr && !active[g]) {
    const int32_t* src = assign + (long long)g * R;
    int32_t* dst = proposal + (long long)g * R;
    for (int r = tid; r < R; r += THREADS) dst[r] = src[r];
    return;
  }
  int* cur = reinterpret_cast<int*>(smem);  // [P] part sizes
  unsigned char* work = kShared ? smem + head : scratch + g * stride;
  double* gain = reinterpret_cast<double*>(work);             // [cap]
  int32_t* cand = reinterpret_cast<int32_t*>(work + 8LL * cap);  // [cap]
  int32_t* na = cand + cap;                                   // [R]
  unsigned char* moved = reinterpret_cast<unsigned char*>(na + R);  // [R]

  const int nr = num_reads[g];
  const int32_t* as = assign + (long long)g * R;
  const double* dg = diff + (long long)g * R * P;

  for (int p = tid; p < P; p += THREADS) cur[p] = 0;
  if (tid == 0) s_count = 0;
  __syncthreads();

  // 1. The assignment and the live part sizes.
  for (int r = tid; r < R; r += THREADS) {
    const int a = as[r];
    na[r] = a;
    moved[r] = 0;
    if (r < nr && a >= 0 && a < P) atomicAdd(&cur[a], 1);
  }
  __syncthreads();

  // 2-3. Valid candidates, compacted.
  const int RP = R * P;
  for (int e0 = 0; e0 < RP; e0 += THREADS) {
    const int e = e0 + tid;
    bool valid = false;
    double gn = 0.0;
    if (e < RP) {
      const int r = e / P;
      if (r < nr) {
        const int j = e - r * P;
        const int a = na[r];
        const int aw = min(max(a < 0 ? a + P : a, 0), P - 1);
        gn = dg[(long long)r * P + aw] - dg[e];
        valid = gn > 0.0 && j != a && cur[aw] > 1;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, valid);
    if (m != 0u) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_count, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (valid) {
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        gain[pos] = gn;
        cand[pos] = e;
      }
    }
  }
  __syncthreads();
  const int n = s_count;

  // 4. Sort the n candidates: gain descending, then k ascending.
  int lg_n = 0;
  while ((1 << lg_n) < n) ++lg_n;
  const int pairs = (1 << lg_n) >> 1;
  for (int ls = 1; ls <= lg_n; ++ls) {
    // Flip: i against its mirror in each block of 2^ls.
    const int lh = ls - 1;
    for (int t = tid; t < pairs; t += THREADS) {
      const int blk = t >> lh;
      const int off = t & ((1 << lh) - 1);
      const int lo = (blk << ls) + off;
      const int hi = (blk << ls) + (1 << ls) - 1 - off;
      if (hi < n) order_pair(gain, cand, lo, hi);
    }
    __syncthreads();
    // Half-cleaners at distances 2^(ls-2) .. 1.
    for (int ld = ls - 2; ld >= 0; --ld) {
      for (int t = tid; t < pairs; t += THREADS) {
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
  int32_t* out = proposal + (long long)g * R;
  for (int r = tid; r < R; r += THREADS) out[r] = na[r];
}

}  // namespace

// `smem` bytes of dynamic shared memory: `head` (the part sizes) plus, when
// `scratch` is null, the per-instance work arrays (12 * cap + 5 * R bytes,
// rounded up); otherwise those live at scratch + g * stride. `active`
// ([G] bytes) may be null.
extern "C" int floria_upem_moves(const void* assign, const void* diff,
                                 const void* num_reads, const void* active,
                                 void* proposal,
                                 void* scratch, long long stride, int G,
                                 int R, int P, int cap, int head, int smem,
                                 void* stream) {
  if (G == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (scratch == nullptr) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          upem_moves_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    upem_moves_kernel<true><<<G, THREADS, smem, st>>>(
        (const int32_t*)assign, (const double*)diff,
        (const int32_t*)num_reads, (const unsigned char*)active,
        (int32_t*)proposal, nullptr, 0, R, P, cap, head);
  } else {
    upem_moves_kernel<false><<<G, THREADS, smem, st>>>(
        (const int32_t*)assign, (const double*)diff,
        (const int32_t*)num_reads, (const unsigned char*)active,
        (int32_t*)proposal, (unsigned char*)scratch, stride, R, P, cap,
        head);
  }
  return (int)cudaGetLastError();
}
