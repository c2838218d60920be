"""Driver of the instance API: one job is `phase_instances` over every
(block, ploidy >= 2) instance and then `refine_instances` over every
(block, ploidy >= 1) instance of one contig's worth of synthetic blocks,
ending with the results on the host."""

from __future__ import annotations

import numpy as np

from .. import roofline
from ..blockgen import make_blocks
from reference import phasing as ref


def setup(config, traffic, seed, dev, rec, trace):
    from floria_tpu_torch.kernels.blocktensor import BlockTensor
    from floria_tpu_torch.options import Options
    from floria_tpu_torch.phase import local

    spec = config["blocks"]
    blocks = make_blocks(spec, seed)
    bts = []
    for g, (al, q) in enumerate(blocks):
        R, S = al.shape
        bts.append((g, BlockTensor(
            frag_ids=np.arange(R), lo=1, num_sites=S, num_reads=R,
            alleles=al, weights=ref.phred_weight(q), snp_range=(1, S),
            quals=q)))
    P, W = spec["max_ploidy"], spec["beam_width"]
    phase_p = list(range(traffic["phase_ploidy_from"], P + 1))
    refine_p = list(range(traffic["refine_ploidy_from"], P + 1))
    sample = sample_of(seed, len(blocks), spec["check_blocks"])
    restore = [(local, n, getattr(local, n)) for n in ("_mesh_caches",
                                                       "pull")]
    if trace:
        for name, label in (("_mesh_caches", "api.cache_upload"),
                            ("pull", "api.pull")):
            setattr(local, name, rec.wrap(label, getattr(local, name)))
    return {"restore": restore, "local": local, "bts": bts,
            "blocks": blocks, "dev": dev,
            "options": Options(epsilon=spec["epsilon"], max_ploidy=P,
                               max_number_solns=W),
            "phase_p": phase_p, "refine_p": refine_p, "sample": sample,
            "reads": spec["num_blocks"] * spec["reads_per_block"],
            "kept": [],
            "epsilon": spec["epsilon"],
            "bound_s": roofline.k1_bound_s(blocks, phase_p, W), "W": W}


def sample_of(seed: int, n: int, k: int):
    """The blocks held to the reference: k of n, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0xC4EC])
    return sorted(int(g) for g in rng.choice(n, min(k, n), replace=False))


def run_job(ctx, rec):
    local, bts, opts, dev = ctx["local"], ctx["bts"], ctx["options"], \
        ctx["dev"]
    with rec.span("api.call"):
        with rec.span("api.phase"):
            asg = local.phase_instances(bts, opts, ctx["phase_p"],
                                        device=dev)
        with rec.span("api.refine"):
            refined, stats = local.refine_instances(
                bts, asg, opts, ploidies=ctx["refine_p"], device=dev)
    if rec.job < 0:
        return
    rec.count("api.reads", ctx["reads"])
    rec.count("k1.bound_s", ctx["bound_s"])
    ctx["kept"].append({(g, P): (asg.get((g, P)), refined.get((g, P)),
                                 stats.get((g, P)))
                        for g in ctx["sample"] for P in ctx["refine_p"]})


def release(ctx):
    for mod, name, fn in ctx.pop("restore"):
        setattr(mod, name, fn)
    ctx["bts"] = None


def reference_answers(blocks, g, phase_p, refine_p, epsilon, W,
                      control=False):
    """{P: (beam assignment or None, refined assignment, (bases, errors))}
    of block g by the plain reference (float32 under `control`)."""
    al, q = blocks[g]
    if control:
        wq, eq, scale = ref.phred_weight(q), np.float32(
            ref.epsilon_quanta(epsilon) / ref.QUANTUM), np.float32(1.0)
    else:
        wq, eq, scale = ref.weight_quanta(q), ref.epsilon_quanta(epsilon), \
            ref.QUANTUM
    out = {}
    for P in refine_p:
        beam = (ref.beam_search(al, wq, eq, P, W, scale=scale)
                if P in phase_p else None)
        start = beam if beam is not None else np.zeros(len(al), np.int32)
        climb = ref.upem_climb(al, wq, eq, start, P, scale=scale)
        out[P] = (beam, climb, ref.unit_mec(al, eq, climb, P, scale=scale))
    return out


def compare(kept, answers):
    """(beam, climb, mec) mismatches of the kept calls' answers against
    the reference's {g: {P: answers}}; a missing answer is a mismatch."""
    bad = [0, 0, 0]
    for call in kept:
        for (g, P), (beam, climb, stats) in call.items():
            rb, rc, rs = answers[g][P]
            if rb is not None and (beam is None
                                   or not np.array_equal(beam, rb)):
                bad[0] += 1
            if climb is None or not np.array_equal(climb, rc):
                bad[1] += 1
            if stats is None or tuple(stats) != tuple(rs):
                bad[2] += 1
    return bad


def check(ctx, rec):
    eps = ctx["epsilon"]
    answers = {g: reference_answers(ctx["blocks"], g, ctx["phase_p"],
                                    ctx["refine_p"], eps, ctx["W"])
               for g in ctx["sample"]}
    bad = compare(ctx["kept"], answers)
    return [("beam_mismatch", bad[0], 0), ("climb_mismatch", bad[1], 0),
            ("mec_mismatch", bad[2], 0),
            ("calls_unchecked", int(not ctx["kept"]), 0)]
