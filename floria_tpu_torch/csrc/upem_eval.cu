// K6: the UPEM hill-climb, one CTA (or a cluster of CTAs) per block
// instance.
//
// Replaces floria_tpu/kernels/upem_batch.py `_upem_optimize_device_jit`
// (:320): the move evaluation `_eval_diff_score` (:50), up to
// NUM_ITER_OPTIMIZE rounds of the move function `_apply_moves_single`
// (:259) and the re-evaluation with the accept rule of the climb's
// while_loop (:343-354), then the unit-weight MEC `_eval_mec` (:196) of the
// final assignment. The TPU runs the evaluations as batched MXU einsums
// over 13-bit weight planes. Two kernels on one evaluation (`Climb`):
//   the climb kernel (`floria_upem_climb`, the main path): the whole climb
//     of every instance in one launch, returning best [G, R], mec [G, 2]
//     and diff [G, R, P] (in weight units, as the reference returns it);
//   the evaluation kernel (`floria_upem_eval`): one evaluation of every
//     instance, one CTA each (the climb's evaluation with C = 1), in three
//     modes. The main path launches it for the ploidy-1 MEC of the fused
//     1+2 sweep level; with K4's launch it composes the climb as launches
//     (the card tests and the smoke run's earlier route):
//     init (0): the distances diff [R, P] of every read to every part's
//               consensus and the phred MEC-epsilon score of `assign`
//               (local_clustering.rs:218-260); active = 1;
//     step (1): one iteration after K4 proposed `assign`: an inactive
//               instance returns at once; one whose proposal equals `best`
//               becomes inactive; otherwise the proposal is evaluated and
//               accepted (best, score and diff written) only if its score
//               is higher, else the instance becomes inactive;
//     mec  (2): the unit-weight (bases, errors) of `assign`, the
//               ploidy-sweep stopping statistics
//               (get_mec_stats_epsilon_no_phred).
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
// f64 in the plain version's order (exact: uerr <= R * S <= 2^26). A score
// is -(err + epsq * nlow); the climb compares the int64 costs, which is the
// same comparison.
//
// What bounds it on the H100: bytes, and the latency of the climb's
// dependent steps. An evaluation must read each cell's allele (1 B) and
// weight (4 B) once and write diff (8 B per read and part); its
// operations, ~(P + 2) per cell, are far below the card's rate. The climb
// kernel's design:
//   1. an instance stays on chip for its whole climb: the counts, masks,
//      `diff`, best, the proposal and the move function's work arrays live
//      in shared memory between rounds, and best, diff and mec are written
//      once at the end. A converged instance leaves the loop at once (it
//      would stay unchanged through the reference's remaining lockstep
//      rounds), so the results equal the reference's bit for bit;
//   2. the move function is K4's body (upem_moves_core.cuh) run in place;
//   3. the column pass is parallel over rows and columns: the rows are
//      listed by part, a thread owns 4 columns (4-byte allele and 16-byte
//      weight loads, 4 rows in flight) and every rs-th row of a part, sums
//      its counts in registers and adds them into the shared int64 counts
//      with 64-bit shared-memory atomics (integer sums: any order); the
//      masks and terms follow per (part, column); the distance pass gives a
//      warp to a read and 4 columns to a lane, with the same vector loads.
//      Each read's span of covered columns is found once per climb (one
//      pass over the alleles), and every later pass loads a read's cells
//      only inside it: a read covers a fraction of a block's columns;
//   4. for a small batch (G <= 66) an instance's columns are split over a
//      cluster of C = 2..8 CTAs (the rule of K1, `cluster_width`, keeping
//      >= 128 columns per CTA): each CTA counts its columns, the score
//      terms and each read's distance partials (int64) are summed over the
//      cluster through distributed shared memory after a cluster barrier,
//      and every CTA then runs the same move function on the same summed
//      `diff`, so all take the same decisions and none waits at a barrier
//      another skipped;
//   5. the counts [A, P, S/C] alias the move function's work arrays (dead
//      while the other runs); an instance whose region exceeds the opt-in
//      limit (227 KB on the H100) keeps it in a device scratch the wrapper
//      allocates (kShared = false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "upem_moves_core.cuh"

namespace cg = cooperative_groups;

namespace climb {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int AMAX = 4;    // alleles counted (constants.MAX_ALLELES)
constexpr int PCHUNK = 8;  // parts per sweep of a read's row
constexpr int U = 4;       // rows in flight per thread in the column pass
constexpr int KS = 4;      // chunks in flight per thread in the span pass
// The climb's rounds at most (constants.NUM_ITER_OPTIMIZE).
constexpr int NUM_ITER_OPTIMIZE = 20;
constexpr unsigned kNone = 0xffffffffu;  // four uncovered cells
constexpr long long ONE_Q = 1LL << 26;
constexpr unsigned kEmpty = 0x80u;
constexpr int kStep = 1, kMec = 2;  // the evaluation kernel's modes (0: init)

// Byte offsets in an instance's region (one per CTA); `head` bytes of
// dynamic shared memory (part sizes and row-list offsets) come first.
// Worked out by the wrapper (kernels/upem_batch.py `climb_layout`).
struct Layout {
  long long head, part, best, prop, rows, span, mask, uni, stride;
};

struct Totals {
  long long err, nlow, bases;
};

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long quanta(float w) {
  return (long long)(w * 67108864.0f);  // exact: w is a multiple of 2^-26
}

// Sums t over the CTA; every thread returns with the totals. The trailing
// barrier lets the next call rewrite the partials.
__device__ __forceinline__ Totals block_sum(Totals t, long long (*red)[WARPS]) {
  t.err = warp_sum(t.err);
  t.nlow = warp_sum(t.nlow);
  t.bases = warp_sum(t.bases);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][w] = t.err;
    red[1][w] = t.nlow;
    red[2][w] = t.bases;
  }
  __syncthreads();
  Totals s = {0, 0, 0};
  for (int i = 0; i < WARPS; ++i) {
    s.err += red[0][i];
    s.nlow += red[1][i];
    s.bases += red[2][i];
  }
  __syncthreads();
  return s;
}

// Four cells' alleles of one row from column s (< c1, the CTA's end),
// one signed byte each (-1: uncovered, or past c1). `vec`: one 4-byte
// load (S % 4 == 0 and aligned bases, so s..s+3 < c1).
__device__ __forceinline__ unsigned load_al4(const int8_t* al, long long off,
                                             int s, int c1, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const unsigned*>(al + off));
  unsigned pk = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    pk |= (unsigned)(uint8_t)(s + v < c1 ? al[off + v] : -1) << (8 * v);
  return pk;
}

// Bit v set where byte v of a packed word holds an allele (>= 0).
__device__ __forceinline__ unsigned covered4(unsigned pk) {
  const unsigned m = ~pk & 0x80808080u;
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
         ((m >> 28) & 8u);
}

__device__ __forceinline__ int allele(unsigned pk, int v) {
  return (int)(int8_t)(pk >> (8 * v));
}

// Whether one of four cells holds an allele in [0, A).
__device__ __forceinline__ bool any_counted(unsigned pk, int A) {
  bool any = false;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int x = allele(pk, v);
    any |= x >= 0 && x < A;
  }
  return any;
}

// The four cells' weights (`vec`: one 16-byte load; else the counted
// cells' only, 0 elsewhere).
__device__ __forceinline__ float4 load_w4(const float* wt, long long off,
                                          bool vec, unsigned pk, int A) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(wt + off));
  float w[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int x = allele(pk, v);
    w[v] = x >= 0 && x < A ? __ldg(wt + off + v) : 0.0f;
  }
  return make_float4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float cell(const float4& f, int v) {
  return v == 0 ? f.x : v == 1 ? f.y : v == 2 ? f.z : f.w;
}

// The state of one climb, in one CTA of its instance's cluster. AM: the
// allele slots counted in registers (2, or AMAX when A > 2).
template <bool kShared, int AM>
struct Climb {
  // Column groups in flight per lane in the distance pass: two on the
  // shared route; one on the scratch route, whose device-memory
  // addresses take the registers a second would need (ptxas spills).
  static constexpr int UD = kShared ? 2 : 1;
  int C, rank, g, tid, R, S, P, A, Sc, c0, c1, ncols;
  bool vec;
  long long epsq;
  const int8_t* al;   // [R, S] of the instance
  const float* wt;    // [R, S]
  unsigned char* scratch;
  unsigned char* base;  // this CTA's region
  Layout L;
  int* poff;          // [P + 1] row-list offsets (shared)
  int* fill;          // [P] (shared)
  long long* diff;    // [R, P] the accepted distances, summed
  long long* part;    // [R, P] this CTA's columns' share (diff when C = 1)
  int32_t* rows;      // [R] rows by part
  int* first;         // [R] each read's first covered column in the CTA's
  int* last;          // [R] columns and its last (first > last: none)
  unsigned char* mask;  // [P, Sc] key flags, then masks
  long long* counts;    // [A, P, Sc]
  long long (*red)[WARPS];
  long long (*slot)[3];
  int par;

  // Binds this CTA (`rank` of the C of instance g) to its columns, its
  // inputs and its region's arrays: in shared memory after the `head`
  // bytes, or its slice of the scratch. The head holds the part sizes
  // [P] (the move function's), the row-list offsets [P + 1] and fills
  // [P].
  __device__ void place(unsigned char* smem, unsigned char* scratch_,
                        const Layout& lay, const int8_t* alleles,
                        const float* weights, const float* epsilon, int g_,
                        int C_, int rank_, int R_, int S_, int P_, int A_,
                        int Sc_, int vec_bits, long long (*red_)[WARPS],
                        long long (*slot_)[3]) {
    C = C_;
    rank = rank_;
    g = g_;
    tid = threadIdx.x;
    R = R_;
    S = S_;
    P = P_;
    A = A_;
    Sc = Sc_;
    c0 = rank * Sc;
    c1 = min(S, c0 + Sc);
    ncols = max(0, c1 - c0);
    vec = (vec_bits & 1) != 0;
    epsq = (long long)rint((double)epsilon[g] * 67108864.0);
    al = alleles + (long long)g * R * S;
    wt = weights + (long long)g * R * S;
    scratch = scratch_;
    L = lay;
    poff = reinterpret_cast<int*>(smem) + P;
    fill = poff + P + 1;
    base = kShared ? smem + L.head
                   : scratch + ((long long)g * C + rank) * L.stride;
    diff = reinterpret_cast<long long*>(base);
    part = reinterpret_cast<long long*>(base + L.part);
    rows = reinterpret_cast<int32_t*>(base + L.rows);
    first = reinterpret_cast<int*>(base + L.span);
    last = first + R;
    mask = base + L.mask;
    counts = reinterpret_cast<long long*>(base + L.uni);
    red = red_;
    slot = slot_;
    par = 0;
  }

  // Each read's span among the CTA's columns, once per climb: the passes
  // below skip the column groups outside it, which hold no covered cell.
  // A thread takes chunks of `wdt` columns of a row (16-byte loads when
  // `vec16`), KS in flight; the lanes of a row reduce their bounds
  // before one shared atomic.
  __device__ void spans(bool vec16) {
    for (int r = tid; r < R; r += THREADS) {
      first[r] = INT_MAX;
      last[r] = -1;
    }
    __syncthreads();
    const int wdt = vec16 ? 16 : 4;
    const int nch = (ncols + wdt - 1) / wdt;
    const long long items = (long long)R * nch;
    const int lane = tid & 31;
    for (long long i0 = 0; i0 < items; i0 += (long long)KS * THREADS) {
      unsigned w[KS][4];
      int row[KS], s[KS];
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const long long it = i0 + (long long)k * THREADS + tid;
        row[k] = it < items ? (int)(it / nch) : -1;
        s[k] = row[k] >= 0 ? c0 + (int)(it % nch) * wdt : 0;
        const long long off = (long long)row[k] * S + s[k];
        if (row[k] < 0) {
          w[k][0] = w[k][1] = w[k][2] = w[k][3] = kNone;
        } else if (vec16) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(al + off));
          w[k][0] = q.x;
          w[k][1] = q.y;
          w[k][2] = q.z;
          w[k][3] = q.w;
        } else {
          w[k][0] = load_al4(al, off, s[k], c1, vec);
          w[k][1] = w[k][2] = w[k][3] = kNone;
        }
      }
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const unsigned bits = covered4(w[k][0]) | covered4(w[k][1]) << 4 |
                              covered4(w[k][2]) << 8 |
                              covered4(w[k][3]) << 12;
        int lo = bits ? s[k] + __ffs(bits) - 1 : INT_MAX;
        int hi = bits ? s[k] + 31 - __clz(bits) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, row[k]);
        lo = __reduce_min_sync(peers, lo);
        hi = __reduce_max_sync(peers, hi);
        if (row[k] >= 0 && hi >= 0 && lane == __ffs(peers) - 1) {
          atomicMin(&first[row[k]], lo);
          atomicMax(&last[row[k]], hi);
        }
      }
    }
    __syncthreads();
  }

  // Totals of `asg`'s partition over the instance: err = sum of
  // (total - max) and nlow = keyed columns with max <= 1 weight unit
  // (weighted), or the unit MEC's (bases, errors, max <= 1) terms.
  // Leaves the masks of the CTA's columns in `mask` (weighted).
  __device__ Totals evaluate(const int32_t* asg, bool unit) {
    // Rows by part (their order within a part is free: sums are exact).
    if (tid < P) fill[tid] = 0;
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      const int p = asg[r];
      if (p >= 0 && p < P) atomicAdd(&fill[p], 1);
    }
    for (long long i = tid; i < (long long)A * P * Sc; i += THREADS)
      counts[i] = 0;
    for (int i = tid; i < P * Sc; i += THREADS) mask[i] = 0;
    __syncthreads();
    if (tid == 0) {
      poff[0] = 0;
      for (int p = 0; p < P; ++p) {
        poff[p + 1] = poff[p] + fill[p];
        fill[p] = poff[p];
      }
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      const int p = asg[r];
      if (p >= 0 && p < P) rows[atomicAdd(&fill[p], 1)] = r;
    }
    __syncthreads();

    // Column pass: a thread owns 4 columns and every rs-th row of a part,
    // counts in registers, then adds them into the shared counts.
    const int ncg = (ncols + 3) >> 2;
    const int rs = ncg >= THREADS ? 1 : THREADS / max(ncg, 1);
    for (int item = tid; item < ncg * rs; item += THREADS) {
      const int sl = (item % ncg) * 4;
      const int split = item / ncg;
      const int s = c0 + sl;
      for (int p = 0; p < P; ++p) {
        long long acc[AM][4];
#pragma unroll
        for (int a = 0; a < AM; ++a)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[a][v] = 0;
        unsigned key = 0;
        const int end = poff[p + 1];
        for (int i0 = poff[p] + split; i0 < end; i0 += U * rs) {
          // U rows' loads in flight, only where the group lies in the
          // read's span: alleles and weights together on the vector
          // route, else the weights of the counted cells after them.
          unsigned pk[U];
          long long off[U];
          float4 w[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * rs;
            const int r = i < end ? rows[i] : -1;
            const bool in = r >= 0 && first[r] <= s + 3 && last[r] >= s;
            off[u] = in ? (long long)r * S + s : -1;
            pk[u] = in ? load_al4(al, off[u], s, c1, vec) : kNone;
            w[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (vec && !unit && in) w[u] = load_w4(wt, off[u], true, 0u, A);
          }
          if (!vec && !unit) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (any_counted(pk[u], A))
                w[u] = load_w4(wt, off[u], false, pk[u], A);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int x = allele(pk[u], v);
              if (x >= 0) key |= 1u << v;
              const long long q = unit ? 1LL : quanta(cell(w[u], v));
#pragma unroll
              for (int b = 0; b < AM; ++b)
                if (x == b) acc[b][v] += q;
            }
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (sl + v >= ncols) continue;
          const long long ci = (long long)p * Sc + sl + v;
          if ((key >> v) & 1u) mask[ci] = 1;
#pragma unroll
          for (int b = 0; b < AM; ++b)
            if (b < A && acc[b][v] != 0)
              atomicAdd(reinterpret_cast<unsigned long long*>(
                            &counts[(long long)b * P * Sc + ci]),
                        (unsigned long long)acc[b][v]);
        }
      }
    }
    __syncthreads();

    // Terms and masks per (part, column).
    Totals t = {0, 0, 0};
    for (int idx = tid; idx < P * ncols; idx += THREADS) {
      const int p = idx / ncols;
      const long long ci = (long long)p * Sc + (idx - p * ncols);
      long long maxc = 0, total = 0;
      for (int a = 0; a < A; ++a) {
        const long long c = counts[(long long)a * P * Sc + ci];
        maxc = c > maxc ? c : maxc;
        total += c;
      }
      if (unit) {
        if (total > 0) {
          t.bases += maxc;
          t.err += total - maxc;
          t.nlow += maxc <= 1;
        }
        continue;
      }
      unsigned m = maxc == 0 ? kEmpty : 0u;
      for (int a = 0; a < A; ++a)
        if (counts[(long long)a * P * Sc + ci] < maxc) m |= 1u << a;
      if (mask[ci]) {
        t.err += total - maxc;
        t.nlow += maxc <= ONE_Q;
      }
      mask[ci] = (unsigned char)m;
    }
    // The block sum's barriers also publish every column's masks.
    t = block_sum(t, red);
    if (C > 1) {
      if (tid == 0) {
        slot[par][0] = t.err;
        slot[par][1] = t.nlow;
        slot[par][2] = t.bases;
      }
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      t = {0, 0, 0};
      for (int k = 0; k < C; ++k) {
        const long long* o = cl.map_shared_rank(&slot[par][0], k);
        t.err += o[0];
        t.nlow += o[1];
        t.bases += o[2];
      }
      // The other parity's slots are rewritten only after the next
      // cluster barrier, which every CTA reaches after reading these.
      par ^= 1;
    }
    return t;
  }

  // Each read's distance to each part over the CTA's columns into `part`,
  // then (C > 1) summed over the cluster into `diff`.
  __device__ void distances() {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < R; r += WARPS) {
      const long long row = (long long)r * S + c0;
      // The read's column groups in the CTA's columns (none: lo > hi).
      const int f = max(first[r], c0), l = min(last[r], c1 - 1);
      const int g_lo = f <= l ? (f - c0) >> 2 : 1;
      const int g_hi = f <= l ? (l - c0) >> 2 : 0;
      for (int p0 = 0; p0 < P; p0 += PCHUNK) {
        const int np = min(PCHUNK, P - p0);
        long long acc[PCHUNK];
#pragma unroll
        for (int j = 0; j < PCHUNK; ++j) acc[j] = 0;
        for (int g0 = g_lo + lane; g0 <= g_hi; g0 += 32 * UD) {
          // UD column groups' loads in flight, as in the column pass.
          unsigned pk[UD];
          float4 w[UD];
#pragma unroll
          for (int u = 0; u < UD; ++u) {
            const int sl = 4 * (g0 + 32 * u);
            const bool in = g0 + 32 * u <= g_hi;
            pk[u] = in ? load_al4(al, row + sl, c0 + sl, c1, vec) : kNone;
            w[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (vec && in) w[u] = load_w4(wt, row + sl, true, 0u, A);
          }
          if (!vec) {
#pragma unroll
            for (int u = 0; u < UD; ++u)
              if (any_counted(pk[u], A))
                w[u] = load_w4(wt, row + 4 * (g0 + 32 * u), false, pk[u], A);
          }
#pragma unroll
          for (int u = 0; u < UD; ++u) {
            if (pk[u] == kNone) continue;
            const int sl = 4 * (g0 + 32 * u);
            long long q[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) q[v] = quanta(cell(w[u], v));
#pragma unroll
            for (int j = 0; j < PCHUNK; ++j) {
              if (j < np) {
                const uchar4 m4 = *reinterpret_cast<const uchar4*>(
                    mask + (long long)(p0 + j) * Sc + sl);
                const unsigned m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  const int x = allele(pk[u], v);
                  if (x < 0) continue;
                  if (m[v] & kEmpty)
                    acc[j] += epsq;
                  else if (x < A && ((m[v] >> x) & 1u))
                    acc[j] += q[v];
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < PCHUNK; ++j) {
          const long long v = warp_sum(acc[j]);
          if (lane == 0 && j < np) part[(long long)r * P + p0 + j] = v;
        }
      }
    }
    if (C > 1) {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      for (int i = tid; i < R * P; i += THREADS) {
        long long v = 0;
        for (int k = 0; k < C; ++k) {
          if (kShared) {
            v += cl.map_shared_rank(part, k)[i];
          } else {
            const long long* o = reinterpret_cast<const long long*>(
                scratch + ((long long)g * C + k) * L.stride + L.part);
            v += __ldcg(o + i);
          }
        }
        diff[i] = v;
      }
    }
    __syncthreads();
  }
};

template <bool kShared, int AM>
__global__ void __launch_bounds__(THREADS, 1) upem_climb_kernel(
    const int8_t* __restrict__ alleles,  // [G, R, S], -1 uncovered
    const float* __restrict__ weights,   // [G, R, S]
    const int32_t* __restrict__ assign0,    // [G, R]
    const int32_t* __restrict__ num_reads,  // [G]
    const float* __restrict__ epsilon,      // [G]
    int32_t* __restrict__ best_out,  // [G, R]
    double* __restrict__ diff_out,   // [G, R, P] weight units
    double* __restrict__ mec_out,    // [G, 2]
    unsigned char* __restrict__ scratch,  // [G * C, stride] when !kShared
    Layout L, int R, int S, int P, int A, int Sc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_red[3][WARPS];
  __shared__ long long s_slot[2][3];
  __shared__ int s_count;
  const int C = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int g = blockIdx.x / C;
  Climb<kShared, AM> c;
  c.place(smem, scratch, L, alleles, weights, epsilon, g, C, rank, R, S, P,
          A, Sc, vec, s_red, s_slot);
  int* cur = reinterpret_cast<int*>(smem);  // [P] part sizes
  int32_t* best = reinterpret_cast<int32_t*>(c.base + L.best);
  int32_t* prop = reinterpret_cast<int32_t*>(c.base + L.prop);
  // The move function's work arrays alias the counts, which are dead
  // between an evaluation's masks and the next evaluation.
  const int cap = R * max(P - 1, 0);
  double* gain = reinterpret_cast<double*>(c.base + L.uni);
  int32_t* cand = reinterpret_cast<int32_t*>(c.base + L.uni + 8LL * cap);
  unsigned char* moved = reinterpret_cast<unsigned char*>(cand + cap);
  const int tid = threadIdx.x;
  const int nr = num_reads[g];

  const int32_t* a0 = assign0 + (long long)g * R;
  for (int r = tid; r < R; r += THREADS) best[r] = a0[r];
  c.spans((vec & 2) != 0);  // its barriers publish best too
  Totals t = c.evaluate(best, false);
  long long cost = t.err + c.epsq * t.nlow;  // the score is -cost
  c.distances();
  for (int it = 0; it < NUM_ITER_OPTIMIZE; ++it) {
    floria_moves::move_function(best, c.diff, nr, R, P, cur, &s_count, gain,
                                cand, prop, moved);
    int changed = 0;
    for (int r = tid; r < R; r += THREADS) changed |= prop[r] != best[r];
    // Every CTA of the cluster holds the same best and diff, so it made
    // the same proposal and takes the same decisions below.
    if (!__syncthreads_or(changed)) break;
    t = c.evaluate(prop, false);
    const long long new_cost = t.err + c.epsq * t.nlow;
    if (!(new_cost < cost)) break;
    cost = new_cost;
    c.distances();
    int32_t* tmp = best;
    best = prop;
    prop = tmp;
  }
  t = c.evaluate(best, true);

  if (rank == 0) {
    if (tid == 0) {
      const double eps_grid = (double)c.epsq / 67108864.0;
      mec_out[2 * g] = (double)t.bases;
      mec_out[2 * g + 1] = (double)t.err + eps_grid * (double)t.nlow;
    }
    for (int r = tid; r < R; r += THREADS)
      best_out[(long long)g * R + r] = best[r];
  }
  double* dg = diff_out + (long long)g * R * P;
  for (int i = rank * THREADS + tid; i < R * P; i += C * THREADS)
    dg[i] = (double)c.diff[i] * (1.0 / 67108864.0);  // exact
  // No CTA leaves while another may still read its shared memory.
  if (C > 1) cg::this_cluster().sync();
}

// One evaluation of every instance, one CTA each (the climb's, C = 1),
// in `mode` (init, step or mec; see the top of the file). `diff` and
// `score` are in weight quanta.
template <bool kShared, int AM>
__global__ void __launch_bounds__(THREADS, 1) upem_eval_kernel(
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
    Layout L, int R, int S, int P, int A, int Sc, int vec) {
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
  Climb<kShared, AM> c;
  c.place(smem, scratch, L, alleles, weights, epsilon, g, 1, 0, R, S, P, A,
          Sc, vec, s_red, nullptr);
  c.spans((vec & 2) != 0);
  const Totals t = c.evaluate(as, mode == kMec);
  if (mode == kMec) {
    if (tid == 0) {
      const double eps_grid = (double)c.epsq / 67108864.0;
      mec[2 * g] = (double)t.bases;
      mec[2 * g + 1] = (double)t.err + eps_grid * (double)t.nlow;
    }
    return;
  }
  const double new_score = -(double)(t.err + c.epsq * t.nlow);
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
  c.distances();
  double* dg = diff + (long long)g * R * P;
  for (int i = tid; i < R * P; i += THREADS) dg[i] = (double)c.diff[i];
}

// Raises the dynamic shared-memory limit of kernel `slot` (`fn`) to
// `smem_max` on the current device, once per device.
cudaError_t allow_smem(const void* fn, int slot, int smem_max) {
  static bool set[8][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && set[slot][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_max);
  if (e == cudaSuccess && dev < 64) set[slot][dev] = true;
  return e;
}

}  // namespace climb

// Both kernels take the layout worked out by the wrapper
// (kernels/upem_batch.py `climb_layout`): `lay` holds the Layout's nine
// offsets (bytes). When `scratch` is null an instance's region lives in
// shared memory (lay[0] + lay[8] bytes of it per CTA), else at scratch +
// (g * cluster + rank) * lay[8] and only the head is shared. `vec` bit 0:
// aligned 4-byte allele and 16-byte weight loads; bit 1: 16-byte allele
// loads. A kernel's shared-memory attribute is set once per device, to
// `smem_max`.

// The climb kernel over G instances in clusters of `cluster` CTAs, each
// owning `Sc` columns.
extern "C" int floria_upem_climb(const void* alleles, const void* weights,
                                 const void* assign0, const void* num_reads,
                                 const void* epsilon, void* best, void* diff,
                                 void* mec, void* scratch,
                                 const long long* lay, int G, int R, int S,
                                 int P, int A, int Sc, int vec, int cluster,
                                 int smem_max, void* stream) {
  if (G == 0) return 0;
  if (A < 1 || A > climb::AMAX || P < 1 || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  const climb::Layout L = {lay[0], lay[1], lay[2], lay[3], lay[4],
                           lay[5], lay[6], lay[7], lay[8]};
  const bool shared = scratch == nullptr;
  const long long smem = shared ? L.head + L.stride : L.head;
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const int8_t*, const float*, const int32_t*,
                          const int32_t*, const float*, int32_t*, double*,
                          double*, unsigned char*, climb::Layout, int, int,
                          int, int, int, int);
  const Kernel kernels[4] = {climb::upem_climb_kernel<false, 2>,
                             climb::upem_climb_kernel<false, climb::AMAX>,
                             climb::upem_climb_kernel<true, 2>,
                             climb::upem_climb_kernel<true, climb::AMAX>};
  const int k = 2 * (int)shared + (A > 2);
  const Kernel kern = kernels[k];
  cudaError_t e = climb::allow_smem((const void*)kern, k, smem_max);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(G * cluster));
  cfg.blockDim = dim3(climb::THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, (const int8_t*)alleles, (const float*)weights,
      (const int32_t*)assign0, (const int32_t*)num_reads,
      (const float*)epsilon, (int32_t*)best, (double*)diff, (double*)mec,
      (unsigned char*)scratch, L, R, S, P, A, Sc, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The evaluation kernel in `mode` over G instances, one CTA each (the
// layout's C = 1, Sc >= S).
extern "C" int floria_upem_eval(int mode, const void* alleles,
                                const void* weights, const void* assign,
                                const void* epsilon, void* best, void* score,
                                void* diff, void* active, void* mec,
                                void* scratch, const long long* lay, int G,
                                int R, int S, int P, int A, int Sc, int vec,
                                int smem_max, void* stream) {
  if (G == 0) return 0;
  if (A < 1 || A > climb::AMAX || P < 1 || mode < 0 || mode > climb::kMec ||
      Sc < S)
    return (int)cudaErrorInvalidValue;
  const climb::Layout L = {lay[0], lay[1], lay[2], lay[3], lay[4],
                           lay[5], lay[6], lay[7], lay[8]};
  const bool shared = scratch == nullptr;
  const long long smem = shared ? L.head + L.stride : L.head;
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(int, const int8_t*, const float*, const int32_t*,
                          const float*, int32_t*, double*, double*,
                          unsigned char*, double*, unsigned char*,
                          climb::Layout, int, int, int, int, int, int);
  const Kernel kernels[4] = {climb::upem_eval_kernel<false, 2>,
                             climb::upem_eval_kernel<false, climb::AMAX>,
                             climb::upem_eval_kernel<true, 2>,
                             climb::upem_eval_kernel<true, climb::AMAX>};
  const int k = 2 * (int)shared + (A > 2);
  const Kernel kern = kernels[k];
  cudaError_t e = climb::allow_smem((const void*)kern, 4 + k, smem_max);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G);
  cfg.blockDim = dim3(climb::THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  e = cudaLaunchKernelEx(
      &cfg, kern, mode, (const int8_t*)alleles, (const float*)weights,
      (const int32_t*)assign, (const float*)epsilon, (int32_t*)best,
      (double*)score, (double*)diff, (unsigned char*)active, (double*)mec,
      (unsigned char*)scratch, L, R, S, P, A, Sc, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
