"""Batched UPEM refinement: the port of floria_tpu/kernels/upem_batch.py.

Move evaluation is contractions over reads and sites. Every count and
distance is an integer number of 2^-26 weight quanta below 2^53 and
every product is below 2^26, so f64 matmuls are exact in any summation
order: the reference's 13-bit f32 plane pairs, `_cmp_planes` and the
HIGH/HIGHEST precision contract are not needed. The TF32 guard keeps
f32 out of these products anyway (they run in f64).

On a card the whole hill-climb (`_upem_optimize_device_jit`: the
evaluation, up to NUM_ITER_OPTIMIZE rounds of the move function, the
re-evaluation and the accept rule, the unit MEC) is one launch of K6's
climb kernel (csrc/upem_eval.cu, `upem_climb_cuda`), which never waits on
the host. Its plain version `upem_climb_plain` runs the fixed-round loop
`_climb` over the plain move evaluation (`upem_eval_plain`: f64
contractions) and the plain move function (`apply_moves_plain`:
`_move_candidates` plus a host walk). A converged instance stays unchanged
through the remaining rounds, so both equal the reference's
early-exiting while_loop. The CPU route of `upem_optimize_device` is
`_climb` with an early exit.

K6's evaluation kernel (`upem_eval_cuda`: one evaluation per instance,
the climb kernel's own with one CTA each, in modes init, step and mec) and
K4, the move function alone (csrc/upem_moves.cu, `apply_moves_cuda`), stay
launchable: the sweep launches K6 mec for the ploidy-1 statistics, and the
two compose the climb as launches (`_climb` on CUDA tensors) for the card
tests.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .. import constants

from ..device import check_no_tf32, resolve_device
from . import _build

EVAL_MODES = {"init": 0, "step": 1, "mec": 2}
# Bytes K6's kernels leave to their static shared memory (the block
# reduction's partials, the cluster's score slots) below the card's opt-in
# limit.
_EVAL_STATIC_SMEM = 1024

WEIGHT_SCALE = float(1 << 26)
INV_WEIGHT_SCALE = 1.0 / (1 << 26)


def _one_hot(assign: torch.Tensor, P: int) -> torch.Tensor:
    """[G, R, P] f64 one-hot; out-of-range parts (-1 padding) -> zeros,
    as jax.nn.one_hot."""
    ar = torch.arange(P, device=assign.device)
    return (assign.long()[..., None] == ar).to(torch.float64)


def _eval_diff_score(alleles, weights, assign, epsilon, ploidy: int,
                     max_alleles: int):
    """(diff [G, R, P] f64 quanta, score [G] f64 quanta): each read's
    epsilon-distance to each part's consensus and the phred MEC-epsilon
    score of the partition (local_clustering.rs:218-260)."""
    f64 = torch.float64
    epsq = torch.round(epsilon.to(f64) * WEIGHT_SCALE)             # [G]
    oh = _one_hot(assign, ploidy)                                  # [G,R,P]
    covf = (alleles >= 0).to(f64)
    wq = (weights * WEIGHT_SCALE).to(f64)
    wa = [wq * (alleles == a) for a in range(max_alleles)]         # [G,R,S]
    counts = torch.stack([torch.einsum("grp,grs->gps", oh, w)
                          for w in wa], dim=1)                     # [G,A,P,S]
    maxc = counts.max(dim=1).values                                # [G,P,S]
    nonempty = maxc > 0.0
    diff = torch.einsum("grs,gps->grp", covf,
                        (~nonempty).to(f64)) * epsq[:, None, None]
    for a in range(max_alleles):
        lt = (nonempty & (counts[:, a] < maxc)).to(f64)
        diff = diff + torch.einsum("grs,gps->grp", wa[a], lt)
    has_key = torch.einsum("grp,grs->gps", oh, covf) > 0.0
    total = counts.sum(dim=1)
    errors = torch.where(has_key, total - maxc, 0.0).sum(dim=(1, 2))
    errors = errors + epsq * ((maxc <= WEIGHT_SCALE) & has_key).sum(
        dim=(1, 2)).to(f64)
    return diff, -errors


def _eval_mec(alleles, assign, epsilon, ploidy: int, max_alleles: int
              ) -> torch.Tensor:
    """Unit-weight MEC stats (bases, errors) [G, 2] f64 for the
    ploidy-sweep stopping rules (get_mec_stats_epsilon_no_phred)."""
    f64 = torch.float64
    eps_grid = torch.round(epsilon.to(f64) * WEIGHT_SCALE) / WEIGHT_SCALE
    oh = _one_hot(assign, ploidy)
    covered = alleles >= 0
    ucounts = torch.stack(
        [torch.einsum("grp,grs->gps", oh,
                      ((alleles == a) & covered).to(f64))
         for a in range(max_alleles)], dim=1)                      # [G,A,P,S]
    umax = ucounts.max(dim=1).values
    usum = ucounts.sum(dim=1)
    uhas = usum > 0.0
    ubases = torch.where(uhas, umax, 0.0).sum(dim=(1, 2))
    uerr = torch.where(uhas, usum - umax, 0.0).sum(dim=(1, 2))
    uerr = uerr + eps_grid * ((umax <= 1.0) & uhas).sum(
        dim=(1, 2)).to(f64)
    return torch.stack([ubases, uerr], dim=-1)


def _move_candidates(assign, diff, num_reads):
    """(sizes0 [G, P] int32, order [G, R*P] int64, n_valid [G] int64):
    the candidate moves of `_apply_moves_single`, sorted by gain desc
    then generation order (stable sort, the order of the reference's
    jnp.argsort(stable=True) on the same keys). A negative part wraps to
    P + a, as the reference's indexing wraps it; padding rows are never
    candidates."""
    G, R, P = diff.shape
    dev = diff.device
    live = torch.arange(R, device=dev)[None, :] < num_reads.long()[:, None]
    a = assign.long()
    parts = torch.arange(P, device=dev)
    sizes0 = ((a[..., None] == parts) & live[..., None]).sum(dim=1)
    aw = torch.where(a < 0, a + P, a).clamp(0, P - 1)
    own = diff.gather(2, aw[..., None])[..., 0]
    gains = own[..., None] - diff                                  # [G,R,P]
    valid = ((gains > 0.0) & live[..., None]
             & (parts[None, None, :] != a[..., None])
             & (sizes0.gather(1, aw) > 1)[..., None])
    key = torch.where(valid, -gains, float("inf")).reshape(G, R * P)
    order = torch.sort(key, dim=1, stable=True).indices
    n_valid = valid.reshape(G, R * P).sum(dim=1)
    return sizes0.to(torch.int32), order, n_valid


def apply_moves_plain(assign, diff, num_reads, active=None
                      ) -> torch.Tensor:
    """Plain version of K4, the whole `_apply_moves_single` over a batch:
    the candidates and their stable sort in torch (`_move_candidates`),
    then the sequential capped walk on the host. An instance whose
    `active` flag ([G] bool, None: all) is off proposes its assignment
    unchanged. Proposal [G, R] int32 on the inputs' device."""
    sizes0, order, n_valid = _move_candidates(assign, diff, num_reads)
    G, R = assign.shape
    P = diff.shape[2]
    a = assign.cpu().numpy().astype(np.int32)
    out = a.copy()
    od = order.cpu().numpy()
    nv = n_valid.cpu().numpy()
    sz = sizes0.cpu().numpy()
    live = (np.ones(G, bool) if active is None
            else active.cpu().numpy().astype(bool))
    for g in np.flatnonzero(live):
        n_moves = int(nv[g]) // 10
        if n_moves == 0:
            n_moves = int(nv[g]) // 3 + 1
        moved = np.zeros(R, bool)
        cur = sz[g].copy()
        for k in range(int(nv[g])):
            idx = int(od[g, k])
            r, j = idx // P, idx % P
            i = int(a[g, r])
            if moved[r] or cur[i] == 1:
                continue
            out[g, r] = j
            moved[r] = True
            cur[j] += 1
            cur[i] -= 1
            if k > n_moves:
                break
    return torch.from_numpy(out).to(assign.device)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def moves_layout(R: int, P: int):
    """(cap, head, work): K4's candidate capacity R * (P - 1), the bytes
    of its part sizes and of its per-instance work arrays (f64 gains and
    int32 indices of the candidates, the proposal and moved flags of the
    reads)."""
    cap = R * max(P - 1, 0)
    return cap, _round16(4 * P), _round16(12 * cap + 5 * R)


@functools.lru_cache(maxsize=None)
def _card_index(index: int):
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def card(dev):
    """(SMs, opt-in shared memory per block in bytes) of the card `dev`,
    read once per card."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _card_index(index)


def moves_in_shared(R: int, P: int, dev) -> bool:
    """Whether K4 keeps an instance's work arrays in shared memory (else
    in a device-memory scratch): they fit the card's opt-in limit."""
    _cap, head, work = moves_layout(R, P)
    return head + work <= card(dev)[1]


def _check_inputs(fn: str, expect: dict, dev) -> None:
    """Raise unless each {name: (tensor, dtype, shape)} is a contiguous
    tensor of that dtype and shape on `dev`."""
    for name, (x, dt, shape) in expect.items():
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dt} {shape} tensor on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def apply_moves_cuda(assign, diff, num_reads, active=None) -> torch.Tensor:
    """K4 launch (csrc/upem_moves.cu): the whole `_apply_moves_single`,
    one CTA per instance. CUDA tensors only: assign [G, R] int32, diff
    [G, R, P] f64 quanta, num_reads [G] int32, active [G] bool or None
    (all active), all contiguous. Returns the proposal [G, R] int32."""
    dev = assign.device
    if dev.type != "cuda":
        raise ValueError("apply_moves_cuda needs CUDA tensors")
    if diff.dim() != 3:
        raise ValueError(f"apply_moves_cuda: diff must be [G, R, P], got "
                         f"{tuple(diff.shape)}")
    G, R, P = diff.shape
    expect = {"assign": (assign, torch.int32, (G, R)),
              "diff": (diff, torch.float64, (G, R, P)),
              "num_reads": (num_reads, torch.int32, (G,))}
    if active is not None:
        expect["active"] = (active, torch.bool, (G,))
    _check_inputs("apply_moves_cuda", expect, dev)
    cap, head, work = moves_layout(R, P)
    proposal = torch.empty_like(assign)
    if moves_in_shared(R, P, dev):
        scratch, smem = None, head + work
    else:
        scratch = torch.empty(G * work, dtype=torch.uint8, device=dev)
        smem = head
    lib = _build.get_lib()
    # The C side sets the kernel's shared-memory attribute on the current
    # device: make it the tensors' card.
    with torch.cuda.device(dev):
        rc = lib.floria_upem_moves(
            *(_ptr(x) for x in (assign, diff, num_reads, active, proposal,
                                scratch)), work,
            G, R, P, cap, head, smem,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "upem_moves")
    _build.count_launch("upem_moves")
    return proposal


def apply_moves(assign, diff, num_reads, active=None) -> torch.Tensor:
    """Batched `_apply_moves_single`: proposal [G, R] int32; instances
    whose `active` flag is off propose their assignment unchanged. CUDA
    tensors go to K4, CPU tensors to its plain version."""
    assign = assign.to(torch.int32).contiguous()
    diff = diff.contiguous()
    num_reads = num_reads.to(torch.int32).contiguous()
    if assign.device.type == "cuda":
        return apply_moves_cuda(assign, diff, num_reads, active)
    return apply_moves_plain(assign, diff, num_reads, active)


def eval_in_shared(R: int, S: int, P: int, A: int, dev) -> bool:
    """Whether K6's evaluation kernel keeps an instance's region (the
    climb kernel's layout at one CTA per instance) in shared memory, else
    in a device-memory scratch: it fits the card's opt-in limit."""
    sms, limit = card(dev)
    return climb_plan(1, R, S, P, A, sms, limit, cluster=1)[2]


def _vec_bits(alleles, weights, S: int, Sc: int) -> int:
    """The vector loads K6's kernels may use on these inputs: aligned
    4-byte alleles and 16-byte weights (bit 0), 16-byte allele chunks
    (bit 1), where the rows and columns allow them."""
    vec = (S % 4 == 0 and alleles.data_ptr() % 4 == 0
           and weights.data_ptr() % 16 == 0)
    vec16 = (vec and S % 16 == 0 and Sc % 16 == 0
             and alleles.data_ptr() % 16 == 0)
    return int(vec) | int(vec16) << 1


def upem_eval_cuda(mode: str, alleles, weights, assign, epsilon,
                   ploidy: int, max_alleles: int, state=None):
    """K6's evaluation kernel (csrc/upem_eval.cu), one CTA per instance;
    never waits on the card. CUDA tensors only, contiguous: alleles
    [G, R, S] int8, weights [G, R, S] f32 (unread in mode "mec"), assign
    [G, R] int32, epsilon [G] f32.
    - "init": returns (diff [G, R, P] f64 quanta, score [G] f64 quanta,
      active [G] bool, all True) of `assign`;
    - "step": `assign` is the move function's proposal and state =
      (best [G, R] int32, best_score [G] f64, diff [G, R, P] f64, active
      [G] bool), updated in place by one climb iteration and returned;
    - "mec": returns the unit-weight (bases, errors) [G, 2] f64."""
    dev = alleles.device
    if dev.type != "cuda":
        raise ValueError("upem_eval_cuda needs CUDA tensors")
    if mode not in EVAL_MODES:
        raise ValueError(f"upem_eval_cuda: unknown mode {mode!r}")
    if alleles.dim() != 3:
        raise ValueError(f"upem_eval_cuda: alleles must be [G, R, S], got "
                         f"{tuple(alleles.shape)}")
    G, R, S = alleles.shape
    P, A = ploidy, max_alleles
    if P < 1 or not 1 <= A <= CLIMB_MAX_ALLELES:
        raise ValueError(f"upem_eval_cuda: P={P}, A={A} out of range")
    expect = {"alleles": (alleles, torch.int8, (G, R, S)),
              "weights": (weights, torch.float32, (G, R, S)),
              "assign": (assign, torch.int32, (G, R)),
              "epsilon": (epsilon, torch.float32, (G,))}
    f64 = torch.float64
    best = score = diff = active = mec = None
    if mode == "step":
        best, score, diff, active = state
        expect.update(best=(best, torch.int32, (G, R)),
                      best_score=(score, f64, (G,)),
                      diff=(diff, f64, (G, R, P)),
                      active=(active, torch.bool, (G,)))
    _check_inputs("upem_eval_cuda", expect, dev)
    if mode == "init":
        score = torch.empty(G, dtype=f64, device=dev)
        diff = torch.empty((G, R, P), dtype=f64, device=dev)
        active = torch.empty(G, dtype=torch.bool, device=dev)
    elif mode == "mec":
        mec = torch.empty((G, 2), dtype=f64, device=dev)
    sms, limit = card(dev)
    _c, lay, _fits, arr = climb_plan(1, R, S, P, A, sms, limit, cluster=1)
    scratch = None if eval_in_shared(R, S, P, A, dev) else torch.empty(
        G * lay.stride, dtype=torch.uint8, device=dev)
    lib = _build.get_lib()
    args = (EVAL_MODES[mode],
            *(_ptr(x) for x in (alleles, weights, assign, epsilon, best,
                                score, diff, active, mec, scratch)),
            arr, G, R, S, P, A, lay.Sc, _vec_bits(alleles, weights, S, lay.Sc),
            limit - _EVAL_STATIC_SMEM,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    # The C side sets the kernel's shared-memory attribute on the current
    # device: make it the tensors' card.
    with torch.cuda.device(dev):
        rc = lib.floria_upem_eval(*args)
    _build.check(rc, "upem_eval")
    _build.count_launch("upem_eval")
    if mode == "init":
        return diff, score, active
    return state if mode == "step" else mec


def upem_eval_plain(mode: str, alleles, weights, assign, epsilon,
                    ploidy: int, max_alleles: int, state=None):
    """Plain version of K6, same signature and results: the reference's
    `_eval_diff_score` / `_eval_mec` as f64 contractions and, in mode
    "step", the body of its climb's while_loop after the move function
    (changed = proposal differs from best; accept only a higher score;
    active = accepted), updating `state` in place."""
    if mode == "mec":
        return _eval_mec(alleles, assign, epsilon, ploidy, max_alleles)
    diff, score = _eval_diff_score(alleles, weights, assign, epsilon,
                                   ploidy, max_alleles)
    if mode == "init":
        return diff, score, torch.ones(alleles.shape[0], dtype=torch.bool,
                                       device=alleles.device)
    if mode != "step":
        raise ValueError(f"upem_eval_plain: unknown mode {mode!r}")
    best, best_score, old_diff, active = state
    improved = active & (assign != best).any(dim=1) & (score > best_score)
    best.copy_(torch.where(improved[:, None], assign, best))
    best_score.copy_(torch.where(improved, score, best_score))
    old_diff.copy_(torch.where(improved[:, None, None], diff, old_diff))
    active.copy_(improved)
    return state


def upem_eval(mode: str, alleles, weights, assign, epsilon, ploidy: int,
              max_alleles: int, state=None):
    """K6's function (see `upem_eval_cuda`): CUDA tensors go to K6, CPU
    tensors to its plain version."""
    fn = upem_eval_cuda if alleles.device.type == "cuda" else upem_eval_plain
    return fn(mode, alleles, weights, assign, epsilon, ploidy, max_alleles,
              state)


# Alleles the climb kernel counts per column (constants.MAX_ALLELES).
CLIMB_MAX_ALLELES = 4
# Widest cluster of CTAs per instance, and the fewest columns a CTA of a
# cluster keeps.
CLIMB_MAX_CLUSTER = 8
CLIMB_MIN_COLUMNS = 128

ClimbLayout = collections.namedtuple(
    "ClimbLayout",
    "Sc head part best prop rows span mask uni stride counts moves")


def climb_cluster_width(G: int, S: int, sms: int) -> int:
    """CTAs per instance of the climb kernel: K1's rule (the widest power
    of two up to 8 that keeps 2 * G * width within the card's `sms`;
    `beam.cluster_width`, which K1's C entry applies at its launch), cut
    so that each CTA keeps at least CLIMB_MIN_COLUMNS of the S columns.
    The host needs the width before the launch, as the layout depends on
    it (K1's does not), so the rule is also written here; a card test
    holds the two equal where the cut does not apply."""
    c = 1
    while (c < CLIMB_MAX_CLUSTER and G * c * 2 <= sms
           and -(-S // (2 * c)) >= CLIMB_MIN_COLUMNS):
        c *= 2
    return c


def climb_layout(R: int, S: int, P: int, A: int, C: int) -> ClimbLayout:
    """The climb kernel's bytes per CTA, as offsets into its instance
    region: the summed distances [R, P] int64 at 0, this CTA's share of
    them (`part`; the same array when C = 1), best, the proposal and the
    rows by part [R] int32, each read's span of covered columns [2, R]
    int32, the key flags / masks [P, Sc] bytes, then one region (`uni`)
    that holds either the counts [A, P, Sc] int64 or the move function's
    work arrays (12 bytes per candidate, R * (P - 1) of them, and a moved
    flag per read): the larger, `stride` in all. Sc is the CTA's columns,
    S / C rounded up to 4. `head`: the shared part sizes and row-list
    offsets in front of the region."""
    Sc = (-(-S // C) + 3) // 4 * 4
    head = _round16(4 * (3 * P + 1))
    diff = _round16(8 * R * P)
    part = diff if C > 1 else 0
    best = diff + part
    rows4 = _round16(4 * R)
    prop, rows, span = best + rows4, best + 2 * rows4, best + 3 * rows4
    mask = span + _round16(8 * R)
    uni = mask + _round16(P * Sc)
    counts = 8 * A * P * Sc
    moves = 12 * R * max(P - 1, 0) + R
    return ClimbLayout(Sc, head, part, best, prop, rows, span, mask, uni,
                       uni + _round16(max(counts, moves)), counts, moves)


@functools.lru_cache(maxsize=None)
def climb_plan(G: int, R: int, S: int, P: int, A: int, sms: int,
               limit: int, cluster=None, shared=None):
    """(C, layout, in_shared, the layout as the C side takes it): the
    cluster width (`climb_cluster_width` unless forced), the layout, and
    whether the instance region fits the opt-in `limit` beside the head
    and the kernel's static shared memory (unless forced; else a device
    scratch holds it)."""
    C = climb_cluster_width(G, S, sms) if cluster is None else cluster
    lay = climb_layout(R, S, P, A, C)
    fits = lay.head + lay.stride + _EVAL_STATIC_SMEM <= limit
    arr = (ctypes.c_longlong * 9)(lay.head, lay.part, lay.best, lay.prop,
                                  lay.rows, lay.span, lay.mask, lay.uni,
                                  lay.stride)
    return C, lay, fits if shared is None else shared, arr


def upem_climb_cuda(alleles, weights, assign0, num_reads, epsilon,
                    ploidy: int, max_alleles: int, *, cluster=None,
                    shared=None):
    """K6's climb kernel (csrc/upem_eval.cu): the whole UPEM hill-climb
    of every instance in one launch; never waits on the card. CUDA
    tensors only, contiguous: alleles [G, R, S] int8, weights [G, R, S]
    f32, assign0 [G, R] int32, num_reads [G] int32, epsilon [G] f32.
    `cluster` (CTAs per instance) and `shared` (instance regions in
    shared memory) force a route; by default `climb_plan` picks them.
    Returns (best [G, R] int32, mec [G, 2] f64, diff [G, R, P] f64 in
    weight units)."""
    dev = alleles.device
    if dev.type != "cuda":
        raise ValueError("upem_climb_cuda needs CUDA tensors")
    if alleles.dim() != 3:
        raise ValueError(f"upem_climb_cuda: alleles must be [G, R, S], got "
                         f"{tuple(alleles.shape)}")
    G, R, S = alleles.shape
    P, A = ploidy, max_alleles
    if not 1 <= P <= 64 or not 1 <= A <= CLIMB_MAX_ALLELES:
        raise ValueError(f"upem_climb_cuda: P={P}, A={A} out of range")
    _check_inputs("upem_climb_cuda", {
        "alleles": (alleles, torch.int8, (G, R, S)),
        "weights": (weights, torch.float32, (G, R, S)),
        "assign0": (assign0, torch.int32, (G, R)),
        "num_reads": (num_reads, torch.int32, (G,)),
        "epsilon": (epsilon, torch.float32, (G,))}, dev)
    sms, limit = card(dev)
    C, lay, in_shared, arr = climb_plan(G, R, S, P, A, sms, limit, cluster,
                                        shared)
    best = torch.empty((G, R), dtype=torch.int32, device=dev)
    diff = torch.empty((G, R, P), dtype=torch.float64, device=dev)
    mec = torch.empty((G, 2), dtype=torch.float64, device=dev)
    scratch = None if in_shared else torch.empty(
        G * C * lay.stride, dtype=torch.uint8, device=dev)
    lib = _build.get_lib()
    args = (*(_ptr(x) for x in (alleles, weights, assign0, num_reads,
                                epsilon, best, diff, mec, scratch)),
            arr, G, R, S, P, A, lay.Sc,
            _vec_bits(alleles, weights, S, lay.Sc), C,
            limit - _EVAL_STATIC_SMEM,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    # The C side sets the kernel's shared-memory attribute on the current
    # device: make it the tensors' card.
    with torch.cuda.device(dev):
        rc = lib.floria_upem_climb(*args)
    _build.check(rc, "upem_climb")
    _build.count_launch("upem_climb")
    return best, mec, diff


def upem_climb_plain(alleles, weights, assign0, num_reads, epsilon,
                     ploidy: int, max_alleles: int = constants.MAX_ALLELES,
                     evaluations=None):
    """Plain version of the climb kernel, same inputs and results, on the
    inputs' device: the fixed-round `_climb` over `upem_eval_plain` and
    `apply_moves_plain`. With `evaluations` ([G] int64)
    it also adds each instance's number of rounds that evaluated a changed
    proposal."""
    best = assign0.to(torch.int32).clone()
    best, mec, diff = _climb(
        alleles, weights, best, num_reads.to(torch.int32), epsilon, ploidy,
        max_alleles, early_exit=False, evaluate=upem_eval_plain,
        moves=apply_moves_plain, evaluations=evaluations)
    return best, mec, diff * INV_WEIGHT_SCALE


def upem_optimize_device(alleles, weights, assign0, num_reads, epsilon,
                         ploidy: int,
                         max_alleles: int = constants.MAX_ALLELES, *,
                         device):
    """The whole UPEM hill-climb (optimize_clustering,
    local_clustering.rs:71-130) over a batch, the reference's
    `_upem_optimize_device_jit`. On a card it is one launch of the climb
    kernel, with no host wait; on the CPU the plain versions run the
    rounds in lockstep and stop once no instance is active. Returns
    (refined assigns [G, R] int32, mec_noph [G, 2] f64, diff [G, R, P]
    f64 in weight units)."""
    check_no_tf32()
    dev = resolve_device(device)

    def t(x, dt):
        return torch.as_tensor(x).to(dev, dt).contiguous()

    args = (t(alleles, torch.int8), t(weights, torch.float32))
    nr, ep = t(num_reads, torch.int32), t(epsilon, torch.float32)
    if dev.type == "cuda":
        return upem_climb_cuda(*args, t(assign0, torch.int32), nr, ep,
                               ploidy, max_alleles)
    best = t(assign0, torch.int32).clone()   # the climb updates it in place
    best, mec, diff = _climb(*args, best, nr, ep, ploidy, max_alleles,
                             early_exit=True)
    return best, mec, diff * INV_WEIGHT_SCALE


def _climb(alleles, weights, best, num_reads, epsilon, ploidy: int,
           max_alleles: int, early_exit: bool, evaluate=None, moves=None,
           evaluations=None):
    """Init, NUM_ITER_OPTIMIZE rounds of the move function and the step,
    mec; `best` is refined in place. `evaluate` and `moves` default to
    `upem_eval` and `apply_moves` (K6's modes and K4 on CUDA tensors,
    their plain versions on the CPU). With `early_exit` the rounds stop
    once no instance is active (reading the flags waits on the device).
    `evaluations` ([G] int64, optional) adds each instance's rounds that
    evaluated a changed proposal. Returns (best, mec [G, 2] f64, diff
    [G, R, P] f64 quanta)."""
    evaluate = upem_eval if evaluate is None else evaluate
    moves = apply_moves if moves is None else moves
    diff, score, active = evaluate("init", alleles, weights, best, epsilon,
                                   ploidy, max_alleles)
    state = (best, score, diff, active)
    for _ in range(constants.NUM_ITER_OPTIMIZE):
        if early_exit and not bool(active.any()):
            break
        proposal = moves(best, diff, num_reads, active)
        if evaluations is not None:
            evaluations += active & (proposal != best).any(dim=1)
        evaluate("step", alleles, weights, proposal, epsilon, ploidy,
                 max_alleles, state)
    mec = evaluate("mec", alleles, weights, best, epsilon, ploidy,
                   max_alleles)
    return best, mec, diff
