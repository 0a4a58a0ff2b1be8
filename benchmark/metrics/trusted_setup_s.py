"""trusted_setup_s (s): ``FastGroth16.setup`` in set-up, the card fenced."""


def read(run):
    return run.setup.get("trusted_setup_s")
