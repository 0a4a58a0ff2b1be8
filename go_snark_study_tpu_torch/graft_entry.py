"""Entry points of the port's prover core: a single-device step and a
multi-device dry run.

Counterpart of the repository's ``__graft_entry__.py``:

``entry(device=None)`` returns ``(prove_step, example_args)``: the Groth16
prover core on one device (Pippenger MSM window sums over the witness and
the NTT H(x) pipeline) at JAX's shapes, 8,192 points (the tiled MSM path)
and a 512-point domain.

``dryrun_multichip(n, backend, device=None)`` spawns n ranks and runs, on
each: one sharded prove step at tiny shapes, one ``prove_sharded`` proof of
``mul_chain_r1cs(2^8, seed=11)`` that must verify, and
``dry_shape_check(22, (2, 8))``.  For even n >= 4 the mesh is the 2-D
(2, n/2) ("host", "data") hierarchy; otherwise the 1-D data mesh.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): the single-device Groth16 prover step."""
    from .bn128 import constants as C, default_bn128
    from .interop import jax_to_port
    from .ops.curve_ops import G1Batch
    from .ops.limbs import FieldKernels
    from .ops.msm import MSMEngine
    from .ops.ntt import NTTEngine

    bn = default_bn128()
    Kr = FieldKernels(C.R, device)
    g1b = G1Batch(FieldKernels(C.Q, device))
    msm = MSMEngine(g1b, bn.g1, C.R)
    eng = NTTEngine(Kr)

    # 8192 points: AT the tile threshold, so the step runs the tiled group
    # pipeline (sort plan, apply, merge scan, reduction) that large provers
    # run, not just the small-N path
    n_points, n_domain = 8192, 512
    t_fwd, t_inv = eng.master(n_domain, False), eng.master(n_domain, True)
    ininv = Kr.pack([pow(n_domain, -1, C.R)])
    c_bits = msm.window_bits_for(n_points)

    def prove_step(points, limbs, a_c, b_c, c_c):
        aff = g1b.to_affine(points)
        sums, _bad = msm.window_sums_device(aff, limbs, c_bits)
        ae, be, ce = (eng._transform(x, t_fwd) for x in (a_c, b_c, c_c))
        p = Kr.sub(Kr.mul(ae, be), ce)
        h = Kr.mul_const(eng._transform(p, t_inv), ininv)
        return sums, h

    rng = np.random.RandomState(0)
    draw = lambda n: torch.from_numpy(jax_to_port(rng.randint(0, 256, (32, n), dtype=np.int32))).to(Kr.device)
    pts = g1b.pack([bn.g1.g] * n_points)
    return prove_step, (pts, draw(n_points), draw(n_domain), draw(n_domain), draw(n_domain))


def _dryrun_rank(n_devices: int, device) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    import random

    from .models.groth16 import verify_proof
    from .models.groth16_fast import FastGroth16
    from .parallel import data_mesh, hier_mesh
    from .parallel.prover_step import make_sharded_prove_step
    from .parallel.sharded_prover import dry_shape_check
    from .synthetic import mul_chain_r1cs

    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = hier_mesh(2, n_devices // 2, device)
    else:
        mesh = data_mesh(n_devices, device)
    # tiny shapes: 128 points per rank; a domain whose four-step factors
    # are both divisible by the rank count
    n_points = 128 * n_devices
    k = (max(4 * n_devices * n_devices, 64) - 1).bit_length()
    n_domain = 1 << (k + k % 2)
    step, example = make_sharded_prove_step(mesh, n_points, n_domain)
    sums, h = step(*example)
    assert h.shape == (8, n_domain), h.shape

    sys_ = mul_chain_r1cs(1 << 8, seed=11)
    fast = FastGroth16(device=device)
    setup = fast.setup(sys_, rng=random.Random(1))
    proof = fast.prove_sharded(sys_, setup.pk, mesh, rng=random.Random(2))
    assert verify_proof(setup.vk, proof, sys_.witness[1:2]), "sharded proof failed verification"

    info = dry_shape_check(22, (2, 8))
    assert info["ok"], info
    return info


def dryrun_multichip(n_devices: int, backend: str, device=None) -> None:
    """Spawn ``n_devices`` ranks over ``backend`` and run one sharded prove
    step, one verified sharded proof and the 2^22 shape check on each.
    ``device=None`` is the card (NCCL needs a card per rank; gloo ranks may
    share one), ``"cpu"`` the CPU."""
    from .ops.limbs import resolve_device
    from .parallel.launch import run_ranks

    run_ranks(_dryrun_rank, n_devices, backend, resolve_device(device).type, n_devices, device)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the single-device prove step, then a multi-device dry run")
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("backend", choices=("nccl", "gloo"), help="nccl: one card per rank; gloo: ranks may share one")
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args()
    fn, example = entry(args.device)
    sums, h = fn(*example)
    print(f"entry() ran: window sums {tuple(sums[0].shape)}, h {tuple(h.shape)}")
    dryrun_multichip(args.n_ranks, args.backend, args.device)
    print(f"dryrun_multichip({args.n_ranks}, {args.backend!r}) ok")
