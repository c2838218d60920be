"""Batched UPEM refinement: the port of floria_tpu/kernels/upem_batch.py.

Move evaluation is contractions over reads and sites. Every count and
distance is an integer number of 2^-26 weight quanta below 2^53 and
every product is below 2^26, so f64 matmuls are exact in any summation
order: the reference's 13-bit f32 plane pairs, `_cmp_planes` and the
HIGH/HIGHEST precision contract are not needed. The TF32 guard keeps
f32 out of these products anyway (they run in f64).

The move function (`_apply_moves_single`: part sizes, candidate gains,
their stable sort and the capped walk) is kernel K4 (csrc/upem_moves.cu)
on CUDA, and `_move_candidates` plus a host walk on the CPU. The move
evaluation (`_eval_diff_score`, `_eval_mec`) and the accept rule of one
climb iteration are kernel K6 (csrc/upem_eval.cu) on CUDA, in int64
quanta, and the f64 contractions below on the CPU (`upem_eval_plain`).
On a card the hill-climb (`_upem_optimize_device_jit`) is launches only:
K6 init, NUM_ITER_OPTIMIZE rounds of K4 and K6 step, each masked by the
instances' `active` flags on the device, and K6 mec; it never waits on
the card. A converged instance stays unchanged through the remaining
rounds, so the results equal the reference's early-exiting while_loop.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants

from ..device import check_no_tf32, resolve_device
from . import _build

EVAL_MODES = {"init": 0, "step": 1, "mec": 2}
# Bytes K6 leaves to its static shared memory (the block reduction's
# partials) below the card's opt-in limit.
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


def moves_in_shared(R: int, P: int, dev) -> bool:
    """Whether K4 keeps an instance's work arrays in shared memory (else
    in a device-memory scratch): they fit the card's opt-in limit."""
    _cap, head, work = moves_layout(R, P)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    return head + work <= limit


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


def eval_layout(S: int, P: int, A: int) -> int:
    """Bytes of K6's per-instance work arrays: the int64 counts
    [A, P, S] and the int32 coverage [P, S] (later the part masks)."""
    return _round16(8 * A * P * S + 4 * P * S)


def eval_in_shared(S: int, P: int, A: int, dev) -> bool:
    """Whether K6 keeps an instance's work arrays in shared memory (else
    in a device-memory scratch): they fit the card's opt-in limit."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    return eval_layout(S, P, A) + _EVAL_STATIC_SMEM <= limit


def upem_eval_cuda(mode: str, alleles, weights, assign, epsilon,
                   ploidy: int, max_alleles: int, state=None):
    """K6 launch (csrc/upem_eval.cu), one CTA per instance; never waits
    on the card. CUDA tensors only, contiguous: alleles [G, R, S] int8,
    weights [G, R, S] f32 (unread in mode "mec"), assign [G, R] int32,
    epsilon [G] f32.
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
    if P < 1 or not 1 <= A <= 7:
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
    work = eval_layout(S, P, A)
    if eval_in_shared(S, P, A, dev):
        scratch, smem = None, work
    else:
        scratch = torch.empty(G * work, dtype=torch.uint8, device=dev)
        smem = 0
    lib = _build.get_lib()
    # The C side sets the kernel's shared-memory attribute on the current
    # device: make it the tensors' card.
    with torch.cuda.device(dev):
        rc = lib.floria_upem_eval(
            EVAL_MODES[mode],
            *(_ptr(x) for x in (alleles, weights, assign, epsilon, best,
                                score, diff, active, mec, scratch)),
            work, G, R, S, P, A, smem,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
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


def upem_optimize_device(alleles, weights, assign0, num_reads, epsilon,
                         ploidy: int,
                         max_alleles: int = constants.MAX_ALLELES, *,
                         device):
    """The whole UPEM hill-climb (optimize_clustering,
    local_clustering.rs:71-130) over a batch, in lockstep with
    per-instance convergence masking: the reference's
    `_upem_optimize_device_jit`. On a card it enqueues K6 and K4 launches
    only and never waits; on the CPU the plain versions run the same
    rounds and stop once no instance is active. Returns (refined assigns
    [G, R] int32, mec_noph [G, 2] f64, diff [G, R, P] f64 in weight
    units)."""
    check_no_tf32()
    dev = resolve_device(device)

    def t(x, dt):
        return torch.as_tensor(x).to(dev, dt).contiguous()

    best = t(assign0, torch.int32).clone()   # the climb updates it in place
    best, mec, diff = _climb(
        t(alleles, torch.int8), t(weights, torch.float32), best,
        t(num_reads, torch.int32), t(epsilon, torch.float32), ploidy,
        max_alleles, early_exit=dev.type == "cpu")
    return best, mec, diff * INV_WEIGHT_SCALE


def _climb(alleles, weights, best, num_reads, epsilon, ploidy: int,
           max_alleles: int, early_exit: bool):
    """K6 init, NUM_ITER_OPTIMIZE rounds of the move function and K6
    step, K6 mec; `best` is refined in place. With `early_exit` the
    rounds stop once no instance is active (reading the flags waits on
    the device, so only the CPU route asks for it). Returns (best, mec
    [G, 2] f64, diff [G, R, P] f64 quanta)."""
    diff, score, active = upem_eval("init", alleles, weights, best, epsilon,
                                    ploidy, max_alleles)
    state = (best, score, diff, active)
    for _ in range(constants.NUM_ITER_OPTIMIZE):
        if early_exit and not bool(active.any()):
            break
        proposal = apply_moves(best, diff, num_reads, active)
        upem_eval("step", alleles, weights, proposal, epsilon, ploidy,
                  max_alleles, state)
    mec = upem_eval("mec", alleles, weights, best, epsilon, ploidy,
                    max_alleles)
    return best, mec, diff
