"""rerun_share.<kind> (%): the window's requests whose MSM the program ran
again with its complete formulas after the degeneracy flag fired (its
engines' ``fallback_hits``), per completed request."""


def read(run):
    return 100.0 * run.reruns / run.completed if run.completed else None
