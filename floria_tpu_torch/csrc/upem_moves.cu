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
// device-memory round trip between steps. The steps are
// `floria_moves::move_function` (upem_moves_core.cuh), which K6's climb
// kernel (upem_eval.cu) runs between its evaluations; on the main path the
// move function runs there, and this launch serves the card tests and the
// smoke run's checks and its earlier launch route.
//
// An `active` mask (null: every instance active) lets a caller run a fixed
// number of rounds without a host wait: an inactive instance's CTA copies
// its assignment to the proposal and returns, so a converged instance
// proposes nothing and costs one load of its flag per round.
//
// Shared memory per instance: 12 bytes per possible candidate (at most
// R * (P - 1)) plus 5 per read. When that exceeds the card's opt-in limit
// (227 KB on the H100; e.g. R > 4,600 at P = 5), the same kernel keeps
// those arrays in a device-memory scratch that the wrapper allocates
// (kShared = false); only the P part sizes stay in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "upem_moves_core.cuh"

namespace {

constexpr int THREADS = 512;

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
  floria_moves::move_function(assign + (long long)g * R,
                              diff + (long long)g * R * P, num_reads[g], R,
                              P, cur, &s_count, gain, cand, na, moved);
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
