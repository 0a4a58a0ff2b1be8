"""k1_device_ms.<kind> (ms): K1's device time per profiled request, from
torch.profiler, when the trace holds as many K1 launches as the program
counted (else nothing, and the traced run does not measure)."""


def read(run):
    return run.k1_ms_per_request()
