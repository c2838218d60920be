"""setup_s: seconds from the start of the process to the start of the
window: imports, the card's context, the inputs and the warm job (host
clock)."""


def read(run):
    return run.setup_s
