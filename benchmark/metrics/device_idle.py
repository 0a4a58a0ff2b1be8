"""device_idle.<kind> (%): the share of the profiled requests' stretch in
which no device operation ran, the program's spans off (no fences)."""


def read(run):
    return run.device_idle_pct()
