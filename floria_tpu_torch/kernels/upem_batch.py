"""Batched UPEM refinement: the port of floria_tpu/kernels/upem_batch.py.

Move evaluation is contractions over reads and sites. Every count and
distance is an integer number of 2^-26 weight quanta below 2^53 and
every product is below 2^26, so f64 matmuls are exact in any summation
order: the reference's 13-bit f32 plane pairs, `_cmp_planes` and the
HIGH/HIGHEST precision contract are not needed. The TF32 guard keeps
f32 out of these products anyway (they run in f64).

The move function (`_apply_moves_single`: part sizes, candidate gains,
their stable sort and the capped walk) is kernel K4 (csrc/upem_moves.cu)
on CUDA, one launch per UPEM iteration, and `_move_candidates` plus a
host walk on the CPU. The <= 20 iteration hill-climb stays a host loop
over tensors that syncs once per iteration on `active.any()`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants

from ..device import check_no_tf32, resolve_device
from . import _build

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


def apply_moves_plain(assign, diff, num_reads) -> torch.Tensor:
    """Plain version of K4, the whole `_apply_moves_single` over a batch:
    the candidates and their stable sort in torch (`_move_candidates`),
    then the sequential capped walk on the host. Proposal [G, R] int32 on
    the inputs' device."""
    sizes0, order, n_valid = _move_candidates(assign, diff, num_reads)
    G, R = assign.shape
    P = diff.shape[2]
    a = assign.cpu().numpy().astype(np.int32)
    out = a.copy()
    od = order.cpu().numpy()
    nv = n_valid.cpu().numpy()
    sz = sizes0.cpu().numpy()
    for g in range(G):
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


def apply_moves_cuda(assign, diff, num_reads) -> torch.Tensor:
    """K4 launch (csrc/upem_moves.cu): the whole `_apply_moves_single`,
    one CTA per instance. CUDA tensors only: assign [G, R] int32, diff
    [G, R, P] f64 quanta, num_reads [G] int32, all contiguous. Returns
    the proposal [G, R] int32."""
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
    for name, (x, dt, shape) in expect.items():
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"apply_moves_cuda: {name} must be a contiguous {dt} "
                f"{shape} tensor on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    cap, head, work = moves_layout(R, P)
    proposal = torch.empty_like(assign)
    if moves_in_shared(R, P, dev):
        scratch, smem = None, head + work
    else:
        scratch = torch.empty(G * work, dtype=torch.uint8, device=dev)
        smem = head
    lib = _build.get_lib()
    ptr = ctypes.c_void_p
    # The C side sets the kernel's shared-memory attribute on the current
    # device: make it the tensors' card.
    with torch.cuda.device(dev):
        rc = lib.floria_upem_moves(
            *(ptr(x.data_ptr()) for x in (assign, diff, num_reads,
                                          proposal)),
            ptr(None if scratch is None else scratch.data_ptr()), work,
            G, R, P, cap, head, smem,
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "upem_moves")
    _build.count_launch("upem_moves")
    return proposal


def apply_moves(assign, diff, num_reads) -> torch.Tensor:
    """Batched `_apply_moves_single`: proposal [G, R] int32. CUDA
    tensors go to K4, CPU tensors to its plain version."""
    assign = assign.to(torch.int32).contiguous()
    diff = diff.contiguous()
    num_reads = num_reads.to(torch.int32).contiguous()
    if assign.device.type == "cuda":
        return apply_moves_cuda(assign, diff, num_reads)
    return apply_moves_plain(assign, diff, num_reads)


def upem_optimize_device(alleles, weights, assign0, num_reads, epsilon,
                         ploidy: int,
                         max_alleles: int = constants.MAX_ALLELES, *,
                         device):
    """The whole UPEM hill-climb (optimize_clustering,
    local_clustering.rs:71-130) over a batch, in lockstep with
    per-instance convergence masking. Returns (refined assigns [G, R]
    int32, mec_noph [G, 2] f64, diff [G, R, P] f64 in weight units)."""
    check_no_tf32()
    dev = resolve_device(device)
    alleles = torch.as_tensor(alleles).to(dev, torch.int8)
    weights = torch.as_tensor(weights).to(dev, torch.float32)
    best = torch.as_tensor(assign0).to(dev, torch.int32).contiguous()
    num_reads = torch.as_tensor(num_reads).to(dev, torch.int32)
    epsilon = torch.as_tensor(epsilon).to(dev, torch.float32)
    G = alleles.shape[0]

    diff, best_score = _eval_diff_score(alleles, weights, best, epsilon,
                                        ploidy, max_alleles)
    active = torch.ones(G, dtype=torch.bool, device=dev)
    it = 0
    while it < constants.NUM_ITER_OPTIMIZE and bool(active.any()):
        proposal = apply_moves(best, diff, num_reads)
        changed = (proposal != best).any(dim=1)
        active = active & changed
        new_diff, new_score = _eval_diff_score(
            alleles, weights, proposal, epsilon, ploidy, max_alleles)
        improved = active & (new_score > best_score)
        best = torch.where(improved[:, None], proposal, best)
        best_score = torch.where(improved, new_score, best_score)
        diff = torch.where(improved[:, None, None], new_diff, diff)
        active = improved
        it += 1
    mec = _eval_mec(alleles, best, epsilon, ploidy, max_alleles)
    return best, mec, diff * INV_WEIGHT_SCALE
