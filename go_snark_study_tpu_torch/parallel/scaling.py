"""Weak-scaling report for the sharded MSM: fixed work per rank on 1, 2, 4
and "2x4" ranks.

Counterpart of ``go_snark_study_tpu/parallel/scaling.py``.  Each layout is
one :func:`.launch.run_ranks` spawn; rank 0's row is kept.

    python -m go_snark_study_tpu_torch.parallel.scaling [per_rank_points] [--cpu] [--backend gloo|nccl]

Caveat printed with the table: ranks that share one card (gloo) or the
host's cores (the CPU) run one after another on the same hardware, so the
wall-time "efficiency" measures sharding and communication overhead, not
speed-up.  On separate cards the local pipelines run concurrently and the
only serial cost is the all_gather + log2(D) tree adds of W window-sum
points (a few KB a rank).  The report's purpose is (a) correctness at every
layout and (b) that the communication volume stays flat as ranks grow.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import torch

from ..ops.limbs import resolve_device
from .launch import run_ranks

__all__ = ["run", "main"]


def _layout(spec):
    """1, 2, 4 -> a 1-D mesh; "HxD" -> the 2-D (host, data) hierarchy."""
    if isinstance(spec, str):
        h, d = (int(x) for x in spec.split("x"))
        return (h, d), h * d
    return spec, spec


def _rank_row(per_dev: int, spec, device) -> dict:
    """One rank's share of a weak-scaling row (run under ``run_ranks``)."""
    from ..bn128 import constants as C, default_bn128
    from ..ops.curve_ops import G1Batch
    from ..ops.limbs import FieldKernels
    from ..ops.msm import combine_window_sums, scalars_to_limbs
    from .mesh import mesh_for
    from .sharded_msm import ShardedMSMEngine

    layout, ndev = _layout(spec)
    mesh = mesh_for(layout, device)
    bn = default_bn128()
    g1b = G1Batch(FieldKernels(C.Q, mesh.device))
    eng = ShardedMSMEngine(g1b, bn.g1, C.R, mesh)
    rng = random.Random(17)
    n = per_dev * ndev
    scalars = [rng.randrange(C.R) for _ in range(n)]
    lo = mesh.my_rank() * per_dev
    pts = g1b.pack([bn.g1.g] * per_dev)
    limbs = scalars_to_limbs(scalars[lo : lo + per_dev], C.R, mesh.device)
    c = eng.window_bits_for(per_dev)

    def run():
        sums, bad = eng.window_sums_sharded(pts, limbs, c)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return sums, bad

    run()  # the first run builds the kernels and caches
    t0 = time.perf_counter()
    sums, bad = run()
    dt = time.perf_counter() - t0
    # broadcast points share every bucket: the incomplete-formula flag
    # fires by construction here, so combine through the complete twin
    if bad:
        sums, _ = eng.fallback_engine().window_sums_sharded(pts, limbs, c)
    total = combine_window_sums(bn.g1, g1b.unpack(sums), c)
    ok = bn.g1.equal(total, bn.g1.mul_scalar(bn.g1.g, sum(scalars) % C.R))
    return {
        "devices": ndev,
        "layout": spec if isinstance(spec, str) else "1d",
        "points": n,
        "seconds": dt,
        "correct": bool(ok),
        "device": str(mesh.device),
    }


def run(per_dev: int = 2048, world_sizes=(1, 2, 4, "2x4"), backend: str = "gloo", device=None) -> list:
    """Weak-scaling rows, one spawn of ranks per layout.  ``device=None``
    is the card (every rank on ``cuda:rank % count``); ``"cpu"`` the CPU.
    With NCCL the layouts stop at one rank per card."""
    dev_type = resolve_device(device).type
    rows = []
    for spec in world_sizes:
        _, ndev = _layout(spec)
        if backend == "nccl" and ndev > torch.cuda.device_count():
            break
        rows.append(run_ranks(_rank_row, ndev, backend, dev_type, per_dev, spec, device)[0])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("per_dev", nargs="?", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args(argv)
    rows = run(args.per_dev, backend=args.backend, device="cpu" if args.cpu else None)
    t1 = rows[0]["seconds"]
    print(f"weak scaling, {args.per_dev} points/rank on {rows[0]['device']}, {args.backend} "
          "(ranks sharing one card or the host's cores measure overhead, not speed-up)")
    print(f"{'ranks':>8}{'layout':>8}{'points':>10}{'wall s':>10}{'efficiency':>12}{'correct':>9}")
    for r in rows:
        print(f"{r['devices']:>8}{r['layout']:>8}{r['points']:>10}"
              f"{r['seconds']:>10.3f}{t1 / r['seconds']:>12.2f}{str(r['correct']):>9}")
    return 0 if all(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
