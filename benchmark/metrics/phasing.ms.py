"""phasing.ms: per CLI job, the program's own stage time of the phasing sweep
(floria_tpu_torch.timing.STAGE_TIMES["phasing"], read after each job)."""


def read(run):
    vals = [st.get("phasing") for st in run.stage_times]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals) * 1e3
