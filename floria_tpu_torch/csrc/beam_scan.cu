// K1: the whole per-read beam scan of one block instance per CTA, or per
// thread-block cluster when the batch is small.
//
// Replaces the TPU kernel floria_tpu/kernels/beam_pallas.py
// (`beam_search_batch_pallas`, body `_make_kernel`, pallas_call at :427)
// with the production semantics of floria_tpu/kernels/beam.py
// (`_step_hist` :622 / `_step_planes` :782, `_rank_select` :103), and
// folds `traceback_batch` (:1227) into the epilogue.
//
// What bounds it on the H100: the traffic of the beam state. Counts are
// exact int64 weight quanta, [B1, P, S, A] per instance (8.2 MB at B1=50,
// P=5, A=2, S=2048): far above a CTA's 227 KB of shared memory, so the
// state lives in device memory as ping-pong buffers and every step streams
// the live slots' columns once. The function's own inputs (each read's
// alleles and weights over its span) are a small fraction of that, so the
// kernel is far from its bound; what the design does is cut the state
// traffic and the serial work per step:
//   - Frontier columns. The pass of step t touches only [lo[t+1],
//     hi[t+1]): lo is the suffix minimum of the reads' first covered
//     columns, hi the prefix maximum of their ends (the wrapper computes
//     both). No later read touches a column below lo; every count at or
//     above hi is zero. Columns enter the frontier as zeros (never read
//     from memory), so the buffers need no initialisation.
//   - One read and one write per step. The update of step t (copy the
//     parent's columns, insert read t into its part) and the scoring of
//     read t+1 against the new state (same / diff / no-evidence sums per
//     (slot, part)) are one pass; the layout keeps the A counts of a
//     column contiguous, so a column is one 16-byte load at A = 2.
//   - Incremental dedup fingerprints. A truncated block's fingerprint,
//     sum over its reads of their suffix hashes from the current read's
//     start, equals sum over columns s >= start of counts[a, s] * H[a, s]
//     (mod 2^32): it is linear in the counts, so the same pass computes it
//     (O(1) per column, no assignment history is kept at all).
//   - Parallel bookkeeping: live, child and candidate lists by warp ballots
//     and a block prefix sum; rank-select counts only the finite
//     candidates that survive the prune and the dedup (O(F) per thread).
//   - Thread-block clusters when G is small: an instance's columns are
//     split over the C CTAs of a cluster (column chunk k belongs to CTA
//     k % C, so each CTA reads only what it wrote), the per-(slot, part)
//     partial sums are reduced once per step over distributed shared
//     memory, and every CTA repeats the small bookkeeping.
// Exactness: counts, same/diff sums and scores are integer quanta (int64,
// scores as f64 integers < 2^53), fingerprints wrap in u32 as the
// reference's do; only the binomial-tail / log-sum-exp prune is
// transcendental (f64, CUDA libdevice log/exp), evaluated as before.
// Compiled with -fmad=false so it rounds like the plain PyTorch path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int NF = 2;                   // dedup fingerprints
constexpr int CB = 128;                 // columns per work chunk
constexpr int CPL = CB / 32;            // columns per lane in a chunk
constexpr int MAX_CLUSTER = 8;
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long quanta(float w) {
  return (long long)((double)w * WEIGHT_SCALE);
}

// Shared-memory layout, the same on host and device. N1 = B1 * P
// (slot, part) pairs; partial-sum rows are N1 + 1 (the last one holds
// the next read's own hash), double-buffered by step parity.
__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o += (bytes + 15) & ~(size_t)15;
  return at;
}

struct Layout {
  size_t score, nscore, pval, cand, diffq, part, ph, hh, fpp, sel, la, lb,
      live, nlive, dup, total;
  __host__ __device__ Layout(int B1, int P) {
    const size_t N1 = (size_t)B1 * P, NR = N1 + 1;
    size_t o = 0;
    score = take(o, 8 * B1);
    nscore = take(o, 8 * B1);
    pval = take(o, 8 * N1);
    cand = take(o, 8 * N1);
    diffq = take(o, 8 * N1);
    part = take(o, 8 * 2 * NR * 3);       // sq, dq, ne
    ph = take(o, 4 * N1 * NF);
    hh = take(o, 4 * N1 * NF);
    fpp = take(o, 4 * 2 * NR * NF);       // fingerprint partials
    sel = take(o, 4 * B1);
    la = take(o, 4 * N1);
    lb = take(o, 4 * N1);
    live = take(o, B1);
    nlive = take(o, B1);
    dup = take(o, N1);
    total = o;
  }
};

// Stable compaction of the indices i < n with pred(i) into out[]; returns
// the count. All threads of the block call it.
template <typename Pred>
__device__ int block_compact(int n, Pred pred, int* out, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += NT) {
    const int i = c0 + tid;
    const bool f = i < n && pred(i);
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < NWARP ? wsum[lane] : 0;
      int x = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < NWARP) wsum[lane] = x - v;     // exclusive
      if (lane == 31) wsum[NWARP] = x;          // chunk total
    }
    __syncthreads();
    if (f) out[base + wsum[warp] + __popc(m & ((1u << lane) - 1u))] = i;
    base += wsum[NWARP];
    __syncthreads();
  }
  return base;
}

template <int A>
__device__ __forceinline__ void load_counts(const int64_t* p, long long* v) {
  if constexpr (A % 2 == 0) {
#pragma unroll
    for (int a = 0; a < A; a += 2) {
      const longlong2 x = *reinterpret_cast<const longlong2*>(p + a);
      v[a] = x.x;
      v[a + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int a = 0; a < A; ++a) v[a] = p[a];
  }
}

template <int A>
__device__ __forceinline__ void store_counts(int64_t* p, const long long* v) {
  if constexpr (A % 2 == 0) {
#pragma unroll
    for (int a = 0; a < A; a += 2)
      *reinterpret_cast<longlong2*>(p + a) = make_longlong2(v[a], v[a + 1]);
  } else {
#pragma unroll
    for (int a = 0; a < A; ++a) p[a] = v[a];
  }
}

template <typename RT, int A>
__global__ void __launch_bounds__(NT) beam_scan_kernel(
    const int8_t* __restrict__ alleles,    // [G, R, S]
    const float* __restrict__ weights,     // [G, R, S]
    const int32_t* __restrict__ num_reads, // [G]
    const double* __restrict__ eps,        // [G]
    const int64_t* __restrict__ epsq,      // [G]
    const int32_t* __restrict__ num_parts, // [G]
    const int32_t* __restrict__ rstart,    // [G, R] first covered column
    const int32_t* __restrict__ lo,        // [G, R] suffix min of rstart
    const int32_t* __restrict__ hi,        // [G, R] prefix max of ends
    const uint32_t* __restrict__ hcol,     // [S, NF, A] site constants
    const uint32_t* __restrict__ gmix,     // [NF, P] part mixers
    int64_t* __restrict__ counts,          // [G, 2, B1, P, S, A] scratch
    RT* __restrict__ warm_par, RT* __restrict__ warm_prt,   // [G, T1, B1]
    RT* __restrict__ main_par, RT* __restrict__ main_prt,   // [G, R-T1, W]
    double* __restrict__ out_scores,       // [G, Bf]
    uint8_t* __restrict__ out_live,        // [G, Bf]
    RT* __restrict__ assign,               // [G, R]
    int R, int S, int P, int W, int T1, int dedup, double cutoff) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int B1 = P * W;
  const int N1 = B1 * P;
  const int NR = N1 + 1;
  const int T2 = R - T1;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  const double BIG = (double)1e30f;
  const double BIG_CUT = (double)1e29f;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(B1, P);
  double* score = reinterpret_cast<double*>(smem + L.score);     // [B1]
  double* nscore = reinterpret_cast<double*>(smem + L.nscore);   // [B1]
  double* pval = reinterpret_cast<double*>(smem + L.pval);       // [N1]
  double* cand = reinterpret_cast<double*>(smem + L.cand);       // [N1]
  long long* diffq = reinterpret_cast<long long*>(smem + L.diffq);
  unsigned long long* part =
      reinterpret_cast<unsigned long long*>(smem + L.part);  // [2][NR][3]
  unsigned* ph = reinterpret_cast<unsigned*>(smem + L.ph);       // [N1][NF]
  unsigned* hh = reinterpret_cast<unsigned*>(smem + L.hh);       // [N1][NF]
  unsigned* fpp = reinterpret_cast<unsigned*>(smem + L.fpp);   // [2][NR][NF]
  int* sel = reinterpret_cast<int*>(smem + L.sel);               // [B1]
  int* la = reinterpret_cast<int*>(smem + L.la);                 // [N1]
  int* lb = reinterpret_cast<int*>(smem + L.lb);                 // [N1]
  unsigned char* live = smem + L.live;                           // [B1]
  unsigned char* nlive = smem + L.nlive;                         // [B1]
  unsigned char* dup = smem + L.dup;                             // [N1]
  __shared__ int wsum[NWARP + 1];
  __shared__ unsigned rc[NF];

  const int nr = num_reads[g];
  const int npart = num_parts[g];
  const double eps_g = eps[g];
  const long long epsq_g = epsq[g];
  const size_t row_stride = (size_t)S * A;            // one (slot, part)
  const size_t buf_stride = (size_t)B1 * P * row_stride;
  int64_t* cbase = counts + (size_t)g * 2 * buf_stride;
  const int32_t* rs_g = rstart + (size_t)g * R;
  const int32_t* lo_g = lo + (size_t)g * R;
  const int32_t* hi_g = hi + (size_t)g * R;

  for (int b = tid; b < B1; b += NT) {
    score[b] = (b == 0) ? 0.0 : INF;
    live[b] = (b == 0);
  }
  for (int i = tid; i < 2 * NR * 3; i += NT) part[i] = 0ull;
  for (int i = tid; i < 2 * NR * NF; i += NT) fpp[i] = 0u;
  for (int i = tid; i < N1 * NF; i += NT) ph[i] = 0u;
  __syncthreads();

  // The fused pass of step t (t = -1 scores read 0 against the empty
  // state): children clist[0..ncl) with parents sel[] write the state
  // after read t into buffer Y over [lo[t+1], hi[t+1]) and accumulate
  // read t+1's sums and the fingerprints of the new state into the
  // parity-`par` partials. Then the cluster-wide reduction fills pval,
  // diffq and ph of the children, and rc with read t+1's own hash.
  auto pass = [&](int t, int ncl, const int* clist, const int64_t* cX,
                  int64_t* cY, int par) {
    const int tn = t + 1;
    const int Lc = lo_g[tn];
    const int Hc = hi_g[tn];
    const int Hprev = (t >= 1) ? hi_g[t] : 0;    // parent valid below
    const int rs_n = rs_g[tn];
    const int8_t* al_t = alleles + ((size_t)g * R + (t < 0 ? 0 : t)) * S;
    const float* w_t = weights + ((size_t)g * R + (t < 0 ? 0 : t)) * S;
    const int8_t* al_n = alleles + ((size_t)g * R + tn) * S;
    const float* w_n = weights + ((size_t)g * R + tn) * S;
    unsigned long long* pp = part + (size_t)par * NR * 3;
    unsigned* fp = fpp + (size_t)par * NR * NF;
    if (Hc > Lc) {
      const int k_lo = Lc / CB, k_hi = (Hc - 1) / CB;
      const int k0 = k_lo + ((rank - k_lo) % C + C) % C;
      const int nk = (k0 > k_hi) ? 0 : (k_hi - k0) / C + 1;
      const int rows = ncl * npart + (dedup ? 1 : 0);
      for (int w = warp; w < rows * nk; w += NWARP) {
        const int row = w / nk;
        const int kc = k0 + (w - row * nk) * C;
        const int s0 = kc * CB + lane;
        if (row == ncl * npart) {
          // Read t+1's own hash: sum of wq * H[allele] (mod 2^32).
          unsigned h[NF] = {0u, 0u};
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int s = s0 + 32 * j;
            if (s < Lc || s >= Hc) continue;
            const int a1 = al_n[s];
            if (a1 < 0 || a1 >= A) continue;
            const unsigned wq = (unsigned)quanta(w_n[s]);
#pragma unroll
            for (int f = 0; f < NF; ++f)
              h[f] += wq * hcol[((size_t)s * NF + f) * A + a1];
          }
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            h[f] = warp_sum(h[f]);
            if (lane == 0) atomicAdd(&fp[(size_t)N1 * NF + f], h[f]);
          }
          continue;
        }
        const int ci = row / npart;
        const int q = row - ci * npart;
        const int o = clist[ci];
        int b = -1, ins = -1;
        if (t >= 0) {
          b = sel[o] / P;
          ins = sel[o] - b * P;
        }
        const int64_t* src =
            (b >= 0) ? cX + ((size_t)b * P + q) * row_stride : nullptr;
        int64_t* dst =
            (cY != nullptr) ? cY + ((size_t)o * P + q) * row_stride : nullptr;
        long long v[CPL][A];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int s = s0 + 32 * j;
          if (src != nullptr && s >= Lc && s < Hprev && s < Hc) {
            load_counts<A>(src + (size_t)s * A, v[j]);
          } else {
#pragma unroll
            for (int a = 0; a < A; ++a) v[j][a] = 0;
          }
        }
        long long sq = 0, dq = 0, ne = 0;
        unsigned fph[NF] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int s = s0 + 32 * j;
          if (s < Lc || s >= Hc) continue;
          if (q == ins) {
            const int a_t = al_t[s];
            if (a_t >= 0 && a_t < A) {
              const long long wq = quanta(w_t[s]);
#pragma unroll
              for (int a = 0; a < A; ++a)
                if (a == a_t) v[j][a] += wq;
            }
          }
          if (dst != nullptr) store_counts<A>(dst + (size_t)s * A, v[j]);
          const int a1 = al_n[s];
          if (a1 >= 0) {
            long long maxc = 0, at = 0;
#pragma unroll
            for (int a = 0; a < A; ++a) {
              maxc = v[j][a] > maxc ? v[j][a] : maxc;
              if (a == a1) at = v[j][a];
            }
            if (maxc == 0) ne += 1;
            else if (at == maxc) sq += quanta(w_n[s]);
            else dq += quanta(w_n[s]);
          }
          if (dedup && s >= rs_n) {
#pragma unroll
            for (int f = 0; f < NF; ++f) {
              const uint32_t* hc = hcol + ((size_t)s * NF + f) * A;
#pragma unroll
              for (int a = 0; a < A; ++a)
                fph[f] += (unsigned)v[j][a] * hc[a];
            }
          }
        }
        sq = warp_sum(sq);
        dq = warp_sum(dq);
        ne = warp_sum(ne);
#pragma unroll
        for (int f = 0; f < NF; ++f) fph[f] = warp_sum(fph[f]);
        if (lane == 0) {
          const int i = o * P + q;
          atomicAdd(&pp[(size_t)i * 3 + 0], (unsigned long long)sq);
          atomicAdd(&pp[(size_t)i * 3 + 1], (unsigned long long)dq);
          atomicAdd(&pp[(size_t)i * 3 + 2], (unsigned long long)ne);
#pragma unroll
          for (int f = 0; f < NF; ++f)
            atomicAdd(&fp[(size_t)i * NF + f], fph[f]);
        }
      }
    }
    // Every CTA of the cluster has its partials; sum them.
    cluster.sync();
    for (int k = tid; k < ncl * P; k += NT) {
      const int o = clist[k / P];
      const int q = k % P;
      const int i = o * P + q;
      unsigned long long s3[3] = {0ull, 0ull, 0ull};
      unsigned f2[NF] = {0u, 0u};
      if (q < npart) {
        for (int r = 0; r < C; ++r) {
          const unsigned long long* rp = cluster.map_shared_rank(pp, r);
          const unsigned* rf = cluster.map_shared_rank(fp, r);
#pragma unroll
          for (int c = 0; c < 3; ++c) s3[c] += rp[(size_t)i * 3 + c];
#pragma unroll
          for (int f = 0; f < NF; ++f) f2[f] += rf[(size_t)i * NF + f];
        }
        const long long dtot =
            (long long)s3[1] + epsq_g * (long long)s3[2];
        diffq[i] = dtot;
        const double same = (double)(long long)s3[0] * INV_WEIGHT_SCALE;
        const double diff = (double)dtot * INV_WEIGHT_SCALE;
        pval[i] = binom_tail(same + diff, diff, eps_g);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) ph[(size_t)i * NF + f] = f2[f];
    }
    if (tid < NF) {
      unsigned h = 0u;
      for (int r = 0; r < C; ++r)
        h += cluster.map_shared_rank(fp, r)[(size_t)N1 * NF + tid];
      rc[tid] = h;
    }
    // The other parity's partials were last read before this step's
    // cluster barrier; clear them for the next pass.
    unsigned long long* pq = part + (size_t)(par ^ 1) * NR * 3;
    unsigned* fq = fpp + (size_t)(par ^ 1) * NR * NF;
    for (int i = tid; i < NR * 3; i += NT) pq[i] = 0ull;
    for (int i = tid; i < NR * NF; i += NT) fq[i] = 0u;
    __syncthreads();
  };

  int X = 0;
  int par = 0;
  if (nr > 0) {
    if (tid == 0) la[0] = 0;
    __syncthreads();
    pass(-1, 1, la, nullptr, nullptr, par);
    par ^= 1;
  }

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
      if (rank == 0)
        for (int o = tid; o < outs; o += NT) {
          par_rec[o] = (RT)o;
          prt_rec[o] = (RT)(-1);
        }
      continue;
    }
    const int N = Bin * P;

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

    // Finite candidates, in generation order.
    int nf = block_compact(N, [&](int i) { return cand[i] < INF; }, la,
                           wsum);

    // --- Dedup: wrapping-u32 fingerprints of the truncated blocks. A
    // candidate is a duplicate when an earlier finite one with an equal
    // fingerprint scores at least as high. ---
    if (dedup) {
      for (int k = tid; k < nf; k += NT) {
        const int i = la[k];
        const int b = i / P;
        const int p = i - b * P;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          unsigned h = 0u;
          for (int q = 0; q < P; ++q) h += ph[(b * P + q) * NF + f] *
                                           gmix[f * P + q];
          hh[i * NF + f] = h + gmix[f * P + p] * rc[f];
        }
      }
      __syncthreads();
      for (int k = tid; k < nf; k += NT) {
        const int i = la[k];
        const double ci = cand[i];
        unsigned char d = 0;
        for (int kj = 0; kj < k; ++kj) {
          const int j = la[kj];
          if (cand[j] >= ci && hh[j * NF] == hh[i * NF] &&
              hh[j * NF + 1] == hh[i * NF + 1]) {
            d = 1;
            break;
          }
        }
        dup[k] = d;
      }
      __syncthreads();
      for (int k = tid; k < nf; k += NT)
        if (dup[k]) cand[la[k]] = INF;
      __syncthreads();
      nf = block_compact(N, [&](int i) { return cand[i] < INF; }, la, wsum);
    }

    // --- Rank-select: (score asc, generation asc), INF clamped to BIG
    // after every finite candidate, in generation order. ---
    for (int k = tid; k < nf; k += NT) {
      const int i = la[k];
      const double fi = cand[i];
      int r = 0;
      for (int kj = 0; kj < nf; ++kj) {
        const double fj = cand[la[kj]];
        r += (fj < fi) || (fj == fi && kj < k);
      }
      if (r < outs) sel[r] = i;
    }
    if (nf < outs) {
      block_compact(N, [&](int i) { return !(cand[i] < INF); }, lb, wsum);
      for (int k = tid; nf + k < outs; k += NT) sel[nf + k] = lb[k];
    }
    __syncthreads();
    for (int o = tid; o < outs; o += NT) {
      const int i = sel[o];
      const int b = i / P;
      if (rank == 0) {
        par_rec[o] = (RT)b;
        prt_rec[o] = (RT)(i - b * P);
      }
      const double ss = fmin(cand[i], BIG);
      const bool nlv = (o < width) && (ss < BIG_CUT);
      nscore[o] = nlv ? ss : INF;
      nlive[o] = nlv;
    }
    __syncthreads();

    // --- Update of step t fused with the scoring of read t+1. ---
    if (t + 1 < nr) {
      const int ncl = block_compact(outs, [&](int o) { return nlive[o]; },
                                    lb, wsum);
      const int64_t* cX = cbase + (size_t)X * buf_stride;
      int64_t* cY = cbase + (size_t)(1 - X) * buf_stride;
      pass(t, ncl, lb, cX, cY, par);
      par ^= 1;
      X = 1 - X;
    }
    for (int o = tid; o < outs; o += NT) {
      score[o] = nscore[o];
      live[o] = nlive[o];
    }
    __syncthreads();
  }

  const int Bf = (R > T1) ? W : B1;
  if (rank == 0)
    for (int o = tid; o < Bf; o += NT) {
      out_scores[(size_t)g * Bf + o] = score[o];
      out_live[(size_t)g * Bf + o] = live[o];
    }
  __syncthreads();

  // --- Traceback epilogue (traceback_batch): best live slot, first
  // index on ties, then the parent chain through main and warm records.
  if (rank == 0 && tid == 0) {
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
  // No CTA leaves while another may still read its shared memory.
  cluster.sync();
}

template <typename RT, int A>
int launch(const void* const* in, void* const* out, int G, int R, int S,
           int P, int W, int T1, int dedup, double cutoff, int cluster,
           cudaStream_t stream) {
  const size_t smem = Layout(P * W, P).total;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = beam_scan_kernel<RT, A>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(G * cluster));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, (const int8_t*)in[0], (const float*)in[1],
      (const int32_t*)in[2], (const double*)in[3], (const int64_t*)in[4],
      (const int32_t*)in[5], (const int32_t*)in[6], (const int32_t*)in[7],
      (const int32_t*)in[8], (const uint32_t*)in[9], (const uint32_t*)in[10],
      (int64_t*)out[0], (RT*)out[1], (RT*)out[2], (RT*)out[3], (RT*)out[4],
      (double*)out[5], (uint8_t*)out[6], (RT*)out[7], R, S, P, W, T1, dedup,
      cutoff);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename RT>
int launch_a(int A, const void* const* in, void* const* out, int G, int R,
             int S, int P, int W, int T1, int dedup, double cutoff,
             int cluster, cudaStream_t stream) {
  switch (A) {
    case 2:
      return launch<RT, 2>(in, out, G, R, S, P, W, T1, dedup, cutoff,
                           cluster, stream);
    case 3:
      return launch<RT, 3>(in, out, G, R, S, P, W, T1, dedup, cutoff,
                           cluster, stream);
    case 4:
      return launch<RT, 4>(in, out, G, R, S, P, W, T1, dedup, cutoff,
                           cluster, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The cluster width the launch below picks for G instances: the widest
// power of two up to 8 that keeps G * width within the card's SMs.
extern "C" int floria_beam_cluster(int G) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  int c = 1;
  while (c < MAX_CLUSTER && (long long)G * c * 2 <= sms) c *= 2;
  return c;
}

// in:  alleles, weights, num_reads, eps, epsq, num_parts, rstart, lo, hi,
//      hcol, gmix
// out: counts (scratch), warm_par, warm_prt, main_par, main_prt, scores,
//      live, assign
extern "C" int floria_beam_scan(
    const void* alleles, const void* weights, const void* num_reads,
    const void* eps, const void* epsq, const void* num_parts,
    const void* rstart, const void* lo, const void* hi, const void* hcol,
    const void* gmix, void* counts, void* warm_par, void* warm_prt,
    void* main_par, void* main_prt, void* scores, void* live, void* assign,
    int G, int R, int S, int P, int A, int W, int T1, int dedup, int rec16,
    double cutoff, void* stream) {
  if (G == 0) return 0;
  const void* in[11] = {alleles, weights, num_reads, eps, epsq, num_parts,
                        rstart, lo, hi, hcol, gmix};
  void* out[8] = {counts, warm_par, warm_prt, main_par, main_prt, scores,
                  live, assign};
  const int cluster = floria_beam_cluster(G);
  if (rec16)
    return launch_a<int16_t>(A, in, out, G, R, S, P, W, T1, dedup, cutoff,
                             cluster, (cudaStream_t)stream);
  return launch_a<int8_t>(A, in, out, G, R, S, P, W, T1, dedup, cutoff,
                          cluster, (cudaStream_t)stream);
}
