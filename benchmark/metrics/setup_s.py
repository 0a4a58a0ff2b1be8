"""setup_s (s): process start to the window's start: imports, the card's
initialisation, the kernels' build or load, the cell's set-up and its cold
request."""


def read(run):
    return run.setup_s
