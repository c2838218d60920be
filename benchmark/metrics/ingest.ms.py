"""ingest.ms: per CLI job, the program's own stage time of
ingest and realignment (floria_tpu_torch.timing.STAGE_TIMES
["ingest_realign"], read after each job)."""


def read(run):
    vals = [st.get("ingest_realign") for st in run.stage_times]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals) * 1e3
