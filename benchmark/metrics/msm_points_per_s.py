"""msm_points_per_s (points/s): the points of every MSM completed in the
window over the window's whole time."""


def read(run):
    return run.completed * run.points_per_request / run.window_s if run.completed else None
