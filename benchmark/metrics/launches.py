"""launches.<kind> (launches): device kernels per profiled proof, PyTorch's
own included."""


def read(run):
    t = run.trace
    return len(t.kernels()) / t.requests if t is not None and t.requests else None
