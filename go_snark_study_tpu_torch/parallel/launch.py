"""Run one function on several ranks: one process per rank (SPMD).

    run_ranks(fn, world_size, backend, device_type, *args) -> [result of rank 0, ...]

spawns ``world_size`` processes with ``torch.multiprocessing`` (the
``spawn`` start method: a rank cannot take over its parent's CUDA
context).  Each rank

  * sets its device: on ``device_type="cuda"`` card ``rank % device_count``
    (so several gloo ranks share one card; NCCL refuses two ranks on one
    card), on ``"cpu"`` one intra-op thread, as the ranks are the
    parallelism;
  * joins the process group with ``backend`` through a ``file://``
    rendezvous in a temporary directory (no TCP port to pick, so parallel
    callers never collide);
  * calls ``fn(*args)`` and hands its result back pickled.

The backend is the caller's choice and nothing replaces it when it fails.
A rank that raises makes ``run_ranks`` raise in the caller
(``torch.multiprocessing.ProcessRaisedException``, with the rank's
traceback) after the other ranks are stopped.  ``fn`` must be a top-level
function of a module that a fresh interpreter can import without side
effects, since every rank imports it; ``args`` and the result must pickle.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

__all__ = ["run_ranks", "call_all"]

# a collective that waits longer than this raises on every rank
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def run_ranks(fn, world_size: int, backend: str, device_type: str, *args) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks; returns the results in
    rank order."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', not {device_type!r}")
    with tempfile.TemporaryDirectory(prefix="gosnark-ranks-") as d:
        torch.multiprocessing.start_processes(
            _rank_main,
            args=(world_size, backend, device_type, f"file://{d}/rendezvous", d, fn, args),
            nprocs=world_size,
            join=True,
            start_method="spawn",
        )
        results = []
        for rank in range(world_size):
            with open(os.path.join(d, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def call_all(*calls) -> list:
    """``call_all((f, args), (g, args), ...)`` -> ``[f(*args), g(*args), ...]``:
    several rank programs in one spawn."""
    return [fn(*args) for fn, args in calls]


def _rank_main(rank, world_size, backend, device_type, init_method, out_dir, fn, args):
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size, timeout=COLLECTIVE_TIMEOUT
    )
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
