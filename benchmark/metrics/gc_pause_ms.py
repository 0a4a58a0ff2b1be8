"""gc_pause_ms.<kind> (ms): the collector's pauses that started in the
window, per proof."""


def read(run):
    return sum(p[1] for p in run.gc_pauses) * 1e3 / run.completed if run.completed else None
