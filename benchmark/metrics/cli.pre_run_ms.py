"""cli.pre_run_ms: per CLI job, the wall time of `cli.main` less that of
its call into `pipeline.run` (argument parsing and the -e/-l estimation
pass), from the harness's spans."""


def read(run):
    main = run.span_walls("cli.main")
    inner = run.span_walls("pipeline.run")
    if not main or len(inner) != len(main):
        return None
    return (sum(main) - sum(inner)) / len(main) * 1e3
