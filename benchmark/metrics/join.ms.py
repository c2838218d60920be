"""join.ms: per CLI job, the program's own stage time of
the host join and outputs (floria_tpu_torch.timing.STAGE_TIMES
["join_outputs"], read after each job)."""


def read(run):
    vals = [st.get("join_outputs") for st in run.stage_times]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals) * 1e3
