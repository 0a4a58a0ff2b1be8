"""assembly_ms.<kind> (ms): the host combination and assembly per proof,
from the program's ``prove.combine`` and ``prove.assemble`` spans."""


def read(run):
    s = run.per_request("prove.combine", "prove.assemble")
    return None if s is None else s * 1e3
