// K1: the whole per-read beam scan of one block instance per CTA.
//
// Replaces the TPU kernel floria_tpu/kernels/beam_pallas.py
// (`beam_search_batch_pallas`, body `_make_kernel`, pallas_call at :427)
// with the production semantics of floria_tpu/kernels/beam.py
// (`_step_hist` :622 / `_step_planes` :782, `_rank_select` :103), and
// folds `traceback_batch` (:1227) into the epilogue.
//
// What bounds it on the H100: the beam state. Counts are exact int64
// weight quanta [B1, P, A, S] per instance (8.2 MB at B1=50, P=5, A=2,
// S=2048), far above a CTA's 227 KB of shared memory, so the state
// lives in device memory (ping-pong buffers the wrapper allocates) and
// each step streams the live slots' window columns once to score and
// once to permute. The read loop is sequential by nature, so one CTA
// owns one instance for the whole scan and steps never leave the SM.
// What the design does about it:
//   - only LIVE slots are scored and only LIVE new slots are written:
//     dead slots hold INF scores, are never a finite candidate's
//     parent, and their state is never observed (records of dead slots
//     depend only on candidate order, not on state);
//   - only the step's window columns [off_t, off_t + window) are read
//     or written: columns behind the sorted-read frontier are never read
//     again, columns ahead of it are zero in both buffers;
//   - the small per-step work (prune, dedup fingerprints, rank-select
//     over N = B*P <= a few hundred candidates) stays in shared memory.
// Exactness: counts, same/diff sums and scores are integer quanta
// (int64, scores as f64 integers < 2^53); only the binomial-tail /
// log-sum-exp prune is transcendental (f64, CUDA libdevice log/exp).
// Compiled with -fmad=false so it rounds like the plain PyTorch path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NF = 2;                  // dedup fingerprints
constexpr double WEIGHT_SCALE = 67108864.0;        // 2^26
constexpr double INV_WEIGHT_SCALE = 1.0 / 67108864.0;
constexpr double DIV_FACTOR = 0.25;

__device__ __forceinline__ double binom_tail(double n, double k, double p) {
  n = floor(n);
  k = floor(k);
  double safe_n = (n == 0.0) ? 1.0 : n;
  double a = fmin(fmax(k / safe_n, 1e-7), 0.9999999);
  double rel = a * log(a / p) + (1.0 - a) * log((1.0 - a) / (1.0 - p));
  if (a < p) rel = -rel;
  return (n == 0.0) ? 0.0 : (-n / DIV_FACTOR) * rel;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long quanta(float w) {
  return (long long)((double)w * WEIGHT_SCALE);
}

template <typename RT>
__global__ void __launch_bounds__(NT) beam_scan_kernel(
    const int8_t* __restrict__ alleles,    // [G, R, S]
    const float* __restrict__ weights,     // [G, R, S]
    const int32_t* __restrict__ num_reads, // [G]
    const double* __restrict__ eps,        // [G]
    const int64_t* __restrict__ epsq,      // [G]
    const int32_t* __restrict__ num_parts, // [G]
    const int32_t* __restrict__ offs,      // [G, R]
    const int64_t* __restrict__ zrows,     // [G, NF, R, R] u32 values
    const int64_t* __restrict__ gmix,      // [NF, P] u32 values
    int64_t* __restrict__ counts,          // [G, 2, B1, P, A, S] zeroed
    int8_t* __restrict__ hist,             // [G, 2, B1, R] filled -1
    RT* __restrict__ warm_par, RT* __restrict__ warm_prt,   // [G, T1, B1]
    RT* __restrict__ main_par, RT* __restrict__ main_prt,   // [G, R-T1, W]
    double* __restrict__ out_scores,       // [G, Bf]
    uint8_t* __restrict__ out_live,        // [G, Bf]
    RT* __restrict__ assign,               // [G, R]
    int R, int S, int P, int A, int W, int T1, int window, int dedup,
    double cutoff) {
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = NT / 32;
  const int B1 = P * W;
  const int N1 = B1 * P;
  const int T2 = R - T1;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  const double BIG = (double)1e30f;
  const double BIG_CUT = (double)1e29f;

  extern __shared__ __align__(16) unsigned char smem[];
  double* score = reinterpret_cast<double*>(smem);          // [B1]
  double* nscore = score + B1;                              // [B1]
  double* pval = nscore + B1;                               // [N1]
  double* cand = pval + N1;                                 // [N1]
  long long* diffq = reinterpret_cast<long long*>(cand + N1);  // [N1]
  unsigned* ph = reinterpret_cast<unsigned*>(diffq + N1);   // [NF, N1]
  unsigned* hh = ph + NF * N1;                              // [NF, N1]
  int* sel = reinterpret_cast<int*>(hh + NF * N1);          // [B1]
  int* live_list = sel + B1;                                // [B1]
  unsigned char* live = reinterpret_cast<unsigned char*>(live_list + B1);
  unsigned char* nlive = live + B1;                         // [B1]
  unsigned char* dup = nlive + B1;                          // [N1]
  __shared__ int n_live_s;

  const int nr = num_reads[g];
  const int npart = num_parts[g];
  const double eps_g = eps[g];
  const long long epsq_g = epsq[g];
  const int Wn = (window < S) ? window : S;
  const size_t slot_stride = (size_t)P * A * S;
  const size_t buf_stride = (size_t)B1 * slot_stride;
  int64_t* cbase = counts + (size_t)g * 2 * buf_stride;
  int8_t* hbase = hist + (size_t)g * 2 * B1 * R;

  for (int b = tid; b < B1; b += NT) {
    score[b] = (b == 0) ? 0.0 : INF;
    live[b] = (b == 0);
  }
  __syncthreads();

  int X = 0;
  for (int t = 0; t < R; ++t) {
    const int Bin = (t <= T1) ? B1 : W;      // transition step reads B1
    const int outs = (t < T1) ? B1 : W;
    const int width = (t < T1) ? npart * W : W;
    RT* par_rec = (t < T1) ? warm_par + ((size_t)g * T1 + t) * B1
                           : main_par + ((size_t)g * T2 + (t - T1)) * W;
    RT* prt_rec = (t < T1) ? warm_prt + ((size_t)g * T1 + t) * B1
                           : main_prt + ((size_t)g * T2 + (t - T1)) * W;
    if (t >= nr) {
      // Padding step: state unchanged, identity parents, part -1.
      for (int o = tid; o < outs; o += NT) {
        par_rec[o] = (RT)o;
        prt_rec[o] = (RT)(-1);
      }
      continue;
    }
    const int N = Bin * P;
    const int off = (window < S) ? offs[(size_t)g * R + t] : 0;
    const int8_t* al_t = alleles + ((size_t)g * R + t) * S;
    const float* w_t = weights + ((size_t)g * R + t) * S;
    const int64_t* cX = cbase + (size_t)X * buf_stride;
    int64_t* cY = cbase + (size_t)(1 - X) * buf_stride;
    const int8_t* hX = hbase + (size_t)X * B1 * R;
    int8_t* hY = hbase + (size_t)(1 - X) * B1 * R;

    if (tid == 0) {
      int nl = 0;
      for (int b = 0; b < Bin; ++b)
        if (live[b]) live_list[nl++] = b;
      n_live_s = nl;
    }
    __syncthreads();
    const int nl = n_live_s;

    // --- Scoring: one warp per (live slot, active part). ---
    for (int pi = warp; pi < nl * npart; pi += nwarps) {
      const int b = live_list[pi / npart];
      const int p = pi % npart;
      const int64_t* cb = cX + (size_t)b * slot_stride + (size_t)p * A * S;
      long long sq = 0, dq = 0, ne = 0;
      for (int s = off + lane; s < off + Wn; s += 32) {
        const int a_t = al_t[s];
        if (a_t < 0) continue;
        const long long wq = quanta(w_t[s]);
        long long maxc = 0, at = 0;
        for (int a = 0; a < A; ++a) {
          const long long c = cb[(size_t)a * S + s];
          maxc = c > maxc ? c : maxc;
          if (a == a_t) at = c;
        }
        if (maxc == 0) ne += 1;
        else if (at == maxc) sq += wq;
        else dq += wq;
      }
      sq = warp_sum(sq);
      dq = warp_sum(dq);
      ne = warp_sum(ne);
      if (lane == 0) {
        const long long dtot = dq + epsq_g * ne;
        diffq[b * P + p] = dtot;
        const double same = (double)sq * INV_WEIGHT_SCALE;
        const double diff = (double)dtot * INV_WEIGHT_SCALE;
        pval[b * P + p] = binom_tail(same + diff, diff, eps_g);
      }
    }
    __syncthreads();

    // --- Prune: posterior over the slot's active parts. ---
    for (int i = tid; i < N; i += NT) {
      const int b = i / P;
      const int p = i - b * P;
      double c = INF;
      if (live[b] && p < npart) {
        double m = -INF;
        for (int q = 0; q < npart; ++q) m = fmax(m, pval[b * P + q]);
        double ssum = 0.0;
        for (int q = 0; q < npart; ++q) ssum += exp(pval[b * P + q] - m);
        const double lse = m + log(ssum);
        if (pval[i] - lse > cutoff) c = score[b] + (double)diffq[i];
      }
      cand[i] = c;
    }
    __syncthreads();

    // --- Dedup: wrapping-u32 fingerprints of the truncated blocks. ---
    if (dedup) {
      const int64_t* z0 = zrows + (((size_t)g * NF + 0) * R + t) * R;
      const int64_t* z1 = zrows + (((size_t)g * NF + 1) * R + t) * R;
      for (int i = tid; i < N; i += NT) {
        const int b = i / P;
        const int q = i - b * P;
        if (!live[b]) continue;
        const int8_t* hb = hX + (size_t)b * R;
        unsigned a0 = 0u, a1 = 0u;
        for (int r = 0; r < t; ++r) {
          if (hb[r] == q) {
            a0 += (unsigned)z0[r];
            a1 += (unsigned)z1[r];
          }
        }
        ph[i] = a0;
        ph[N1 + i] = a1;
      }
      __syncthreads();
      const unsigned rc0 = (unsigned)z0[t];
      const unsigned rc1 = (unsigned)z1[t];
      for (int i = tid; i < N; i += NT) {
        if (!(cand[i] < INF)) continue;
        const int b = i / P;
        const int p = i - b * P;
        unsigned h0 = 0u, h1 = 0u;
        for (int q = 0; q < P; ++q) {
          h0 += ph[b * P + q] * (unsigned)gmix[q];
          h1 += ph[N1 + b * P + q] * (unsigned)gmix[P + q];
        }
        hh[i] = h0 + (unsigned)gmix[p] * rc0;
        hh[N1 + i] = h1 + (unsigned)gmix[P + p] * rc1;
      }
      __syncthreads();
      for (int i = tid; i < N; i += NT) {
        unsigned char d = 0;
        const double ci = cand[i];
        if (ci < INF) {
          for (int j = 0; j < i; ++j) {
            const double cj = cand[j];
            if (cj < INF && cj >= ci && hh[j] == hh[i] &&
                hh[N1 + j] == hh[N1 + i]) {
              d = 1;
              break;
            }
          }
        }
        dup[i] = d;
      }
      __syncthreads();
      for (int i = tid; i < N; i += NT)
        if (dup[i]) cand[i] = INF;
      __syncthreads();
    }

    // --- Rank-select: (score asc, generation asc), INF clamped. ---
    for (int i = tid; i < N; i += NT) {
      const double fi = fmin(cand[i], BIG);
      int rank = 0;
      for (int j = 0; j < N; ++j) {
        const double fj = fmin(cand[j], BIG);
        rank += (fj < fi) || (fj == fi && j < i);
      }
      if (rank < outs) sel[rank] = i;
    }
    __syncthreads();
    for (int o = tid; o < outs; o += NT) {
      const int i = sel[o];
      const int b = i / P;
      par_rec[o] = (RT)b;
      prt_rec[o] = (RT)(i - b * P);
      const double ss = fmin(cand[i], BIG);
      const bool nlv = (o < width) && (ss < BIG_CUT);
      nscore[o] = nlv ? ss : INF;
      nlive[o] = nlv;
    }
    __syncthreads();

    // --- Update: live new slots copy their parent's window columns and
    // history row, then insert read t into their part. ---
    for (int row = warp; row < outs * P * A; row += nwarps) {
      const int a = row % A;
      const int q = (row / A) % P;
      const int o = row / (A * P);
      if (!nlive[o]) continue;
      const int i = sel[o];
      const int b = i / P;
      const bool ins = (q == i - b * P);
      const int64_t* src = cX + (size_t)b * slot_stride +
                           ((size_t)q * A + a) * S;
      int64_t* dst = cY + (size_t)o * slot_stride + ((size_t)q * A + a) * S;
      for (int s = off + lane; s < off + Wn; s += 32) {
        long long v = src[s];
        if (ins && al_t[s] == a) v += quanta(w_t[s]);
        dst[s] = v;
      }
    }
    for (int idx = tid; idx < outs * R; idx += NT) {
      const int o = idx / R;
      const int r = idx - o * R;
      if (!nlive[o]) continue;
      const int i = sel[o];
      const int b = i / P;
      hY[(size_t)o * R + r] = (r == t) ? (int8_t)(i - b * P)
                                       : hX[(size_t)b * R + r];
    }
    __syncthreads();
    for (int o = tid; o < outs; o += NT) {
      score[o] = nscore[o];
      live[o] = nlive[o];
    }
    X = 1 - X;
    __syncthreads();
  }

  const int Bf = (R > T1) ? W : B1;
  for (int o = tid; o < Bf; o += NT) {
    out_scores[(size_t)g * Bf + o] = score[o];
    out_live[(size_t)g * Bf + o] = live[o];
  }
  __syncthreads();

  // --- Traceback epilogue (traceback_batch): best live slot, first
  // index on ties, then the parent chain through main and warm records.
  if (tid == 0) {
    int b = 0;
    double bv = live[0] ? score[0] : INF;
    for (int o = 1; o < Bf; ++o) {
      const double v = live[o] ? score[o] : INF;
      if (v < bv) {
        bv = v;
        b = o;
      }
    }
    RT* as = assign + (size_t)g * R;
    for (int t = R - 1; t >= T1; --t) {
      const size_t k = ((size_t)g * T2 + (t - T1)) * W + b;
      as[t] = main_prt[k];
      b = (int)main_par[k];
    }
    for (int t = T1 - 1; t >= 0; --t) {
      const size_t k = ((size_t)g * T1 + t) * B1 + b;
      as[t] = warm_prt[k];
      b = (int)warm_par[k];
    }
  }
}

size_t smem_bytes(int P, int W) {
  const size_t B1 = (size_t)P * W, N1 = B1 * P;
  return B1 * 16 + N1 * 24 + N1 * 4 * NF * 2 + B1 * 8 + B1 * 2 + N1;
}

template <typename RT>
int launch(const void* alleles, const void* weights, const void* num_reads,
           const void* eps, const void* epsq, const void* num_parts,
           const void* offs, const void* zrows, const void* gmix,
           void* counts, void* hist, void* warm_par, void* warm_prt,
           void* main_par, void* main_prt, void* scores, void* live,
           void* assign, int G, int R, int S, int P, int A, int W, int T1,
           int window, int dedup, double cutoff, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, W);
  auto kern = beam_scan_kernel<RT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<G, NT, smem, stream>>>(
      (const int8_t*)alleles, (const float*)weights,
      (const int32_t*)num_reads, (const double*)eps, (const int64_t*)epsq,
      (const int32_t*)num_parts, (const int32_t*)offs,
      (const int64_t*)zrows, (const int64_t*)gmix, (int64_t*)counts,
      (int8_t*)hist, (RT*)warm_par, (RT*)warm_prt, (RT*)main_par,
      (RT*)main_prt, (double*)scores, (uint8_t*)live, (RT*)assign, R, S,
      P, A, W, T1, window, dedup, cutoff);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int floria_beam_scan(
    const void* alleles, const void* weights, const void* num_reads,
    const void* eps, const void* epsq, const void* num_parts,
    const void* offs, const void* zrows, const void* gmix, void* counts,
    void* hist, void* warm_par, void* warm_prt, void* main_par,
    void* main_prt, void* scores, void* live, void* assign, int G, int R,
    int S, int P, int A, int W, int T1, int window, int dedup, int rec16,
    double cutoff, void* stream) {
  if (G == 0) return 0;
  if (rec16)
    return launch<int16_t>(alleles, weights, num_reads, eps, epsq,
                           num_parts, offs, zrows, gmix, counts, hist,
                           warm_par, warm_prt, main_par, main_prt, scores,
                           live, assign, G, R, S, P, A, W, T1, window,
                           dedup, cutoff, (cudaStream_t)stream);
  return launch<int8_t>(alleles, weights, num_reads, eps, epsq, num_parts,
                        offs, zrows, gmix, counts, hist, warm_par, warm_prt,
                        main_par, main_prt, scores, live, assign, G, R, S,
                        P, A, W, T1, window, dedup, cutoff,
                        (cudaStream_t)stream);
}
