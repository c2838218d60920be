"""The control of each cell's comparison: the plain reference computed in
float32, the precision below the configuration's exact arithmetic, put in
the program's place and held to the reference as the program's answers
are. A sound comparison must find it not correct.

    python3 benchmark/control.py --workload config4.cli --seeds 11 12 13

prints one JSON line per seed with the numbers the cell compares (they
need no card: both sides run on the host).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .manifest import Manifest


def control_numbers(manifest: Manifest, workload: str, seed: int) -> dict:
    """{number: value} of the float32 control against the reference on
    what `workload`'s run with `seed` would check."""
    cell = manifest.cell(workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    if traffic["driver"] == "cli":
        from reference import cli as ref_cli
        from .drivers import cli as drv

        k = int(np.random.default_rng([int(seed), 0xC4EC]).integers(
            config["cli"]["pool"]))
        c = drv.community(config, seed, k, drv.inputs_dir())
        texts, sweep = ref_cli.community_texts(c["dir"], config)
        ctexts, csweep = ref_cli.community_texts(c["dir"], config,
                                                 control=True)
        got = [(tuple(rng), [sorted(p) for p in parts], list(mec))
               for rng, parts, mec in csweep]
        bad = drv.compare([(ctexts, got)], texts, sweep)
        return {"texts_differ": bad[0], "blocks_differ": bad[1],
                "mec_differ": bad[2]}
    if traffic["driver"] == "instances":
        from .blockgen import make_blocks
        from .drivers import instances as drv

        spec = config["blocks"]
        blocks = make_blocks(spec, seed)
        P, W = spec["max_ploidy"], spec["beam_width"]
        phase_p = list(range(traffic["phase_ploidy_from"], P + 1))
        refine_p = list(range(traffic["refine_ploidy_from"], P + 1))
        sample = drv.sample_of(seed, len(blocks), spec["check_blocks"])
        answers, call = {}, {}
        for g in sample:
            answers[g] = drv.reference_answers(blocks, g, phase_p, refine_p,
                                               spec["epsilon"], W)
            ctl = drv.reference_answers(blocks, g, phase_p, refine_p,
                                        spec["epsilon"], W, control=True)
            call.update({(g, p): a for p, a in ctl.items()})
        bad = drv.compare([call], answers)
        return {"beam_mismatch": bad[0], "climb_mismatch": bad[1],
                "mec_mismatch": bad[2]}
    raise ValueError(f"no control for driver {traffic['driver']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    manifest = Manifest()
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(manifest, args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0
