"""msm_roofline.<kind> (%): the least time of the profiled requests' MSM
work (benchmark/cost.py, from the inputs alone) over K1's device time."""


def read(run):
    return run.msm_roofline_pct()
