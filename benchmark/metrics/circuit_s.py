"""circuit_s (s): the system's clock around building its circuit's rows in
set-up (``circuit.sha256.r1cs``, ``circuit.keccak.r1cs``); nothing where
the system builds no circuit."""


def read(run):
    return run.setup.get("circuit_s")
