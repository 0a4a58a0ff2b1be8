"""bridge_ms.<kind> (ms): the host bridge per proof, from the program's
``prove.row_evals``, ``prove.witness`` and ``prove.h_inputs`` spans."""


def read(run):
    s = run.per_request("prove.row_evals", "prove.witness", "prove.h_inputs")
    return None if s is None else s * 1e3
