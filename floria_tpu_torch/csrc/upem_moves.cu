// K4: the UPEM move walk, one thread per block instance.
//
// Replaces floria_tpu/kernels/upem_batch.py `_apply_moves_single` (:259),
// a lax.while_loop the TPU runs per instance under vmap
// (local_clustering.rs:292-358). The candidates arrive already sorted
// (torch.sort(stable=True) on key = where(valid, -gain, +inf), the order
// of jnp.argsort(stable=True)); the walk applies them one at a time with
// a running part-size check and stops right after the applied move whose
// index passes the cap n_moves = n_valid // 10 (or n_valid // 3 + 1).
//
// What bounds it on the H100: nothing but latency. The walk is serial
// within an instance and visits ~n_valid / 10 candidates; in plain
// PyTorch it would be a host loop that syncs once per move. One thread
// per instance keeps it on the card in one launch; the per-instance
// state (moved[R], cur[P]) lives in wrapper-allocated scratch and stays
// in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void upem_moves_kernel(
    const int32_t* __restrict__ assign,    // [G, R] original assignment
    const int64_t* __restrict__ order,     // [G, R*P] sorted candidates
    const int64_t* __restrict__ n_valid,   // [G]
    const int32_t* __restrict__ sizes0,    // [G, P] live part sizes
    int32_t* __restrict__ new_assign,      // [G, R] out
    uint8_t* __restrict__ moved,           // [G, R] scratch
    int32_t* __restrict__ cur,             // [G, P] scratch
    int G, int R, int P) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int32_t* as = assign + (size_t)g * R;
  int32_t* na = new_assign + (size_t)g * R;
  uint8_t* mv = moved + (size_t)g * R;
  int32_t* cu = cur + (size_t)g * P;
  for (int r = 0; r < R; ++r) {
    na[r] = as[r];
    mv[r] = 0;
  }
  for (int p = 0; p < P; ++p) cu[p] = sizes0[(size_t)g * P + p];
  const long long nv = n_valid[g];
  long long n_moves = nv / 10;
  if (n_moves == 0) n_moves = nv / 3 + 1;
  const int64_t* ord = order + (size_t)g * R * P;
  for (long long k = 0; k < nv; ++k) {
    const long long idx = ord[k];
    const int r = (int)(idx / P);
    const int j = (int)(idx % P);
    const int i = as[r];  // source = original part: reads move once
    const bool ok = !mv[r] && cu[i] != 1;
    if (ok) {
      na[r] = j;
      mv[r] = 1;
      cu[j] += 1;
      cu[i] -= 1;
      if (k > n_moves) break;
    }
  }
}

}  // namespace

extern "C" int floria_upem_moves(const void* assign, const void* order,
                                 const void* n_valid, const void* sizes0,
                                 void* new_assign, void* moved, void* cur,
                                 int G, int R, int P, void* stream) {
  if (G == 0) return 0;
  const int threads = 128;
  upem_moves_kernel<<<(G + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)assign, (const int64_t*)order,
      (const int64_t*)n_valid, (const int32_t*)sizes0,
      (int32_t*)new_assign, (uint8_t*)moved, (int32_t*)cur, G, R, P);
  return (int)cudaGetLastError();
}
