"""rerun_ms.<kind> (ms): the complete-formula re-runs of a proof's MSMs per
proof, from the program's ``prove.rerun`` span; 0.0 where ``prove.flags``
ran and no re-run fired, nothing where the program has no flag span."""


def read(run):
    if run.per_request("prove.flags") is None:
        return None
    s = run.per_request("prove.rerun")
    return 0.0 if s is None else s * 1e3
