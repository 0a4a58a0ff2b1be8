"""prove_s (s): the window's whole time over the proofs completed in it."""


def read(run):
    return run.window_s / run.completed if run.completed else None
