"""The sharded "training step" of the prover: the two hot phases of Groth16
proof generation over a mesh, as one function.

Counterpart of ``go_snark_study_tpu/parallel/prover_step.py``:

  * the witness MSM (data-parallel Pippenger window sums, points split over
    the ranks, combined with all_gather + tree adds:
    :class:`.sharded_msm.ShardedMSMEngine`), and
  * the H(x) pipeline (four-step NTTs with all_to_all transposes:
    :class:`.sharded_ntt.FourStepNTT` forward transforms of a/b/c, pointwise
    p = a*b - c, inverse transform).

PyTorch runs it eagerly, so there is nothing to compile; every rank calls
``step`` with the same whole inputs, works on its own shard and returns the
same outputs.  This is what ``graft_entry.dryrun_multichip`` runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bn128 import constants as C, default_bn128
from ..interop import jax_to_port
from ..ops.curve_ops import G1Batch, tree_map
from ..ops.limbs import LIMBS, FieldKernels
from ..ops.ntt import NTTEngine
from .mesh import Mesh
from .sharded_msm import ShardedMSMEngine
from .sharded_ntt import FourStepNTT

__all__ = ["make_sharded_prove_step"]


def make_sharded_prove_step(mesh: Mesh, n_points: int, n_domain: int):
    """Returns (step_fn, example_args).

    step_fn(points, windows, a_coeffs, b_coeffs, c_coeffs) ->
        (msm_window_sums, h_coeffs)

    where points is a G1 point pytree with n_points lanes, windows is
    (8, n_points) scalar limbs, and the coefficient vectors are
    (8, n_domain) Fr Montgomery limbs.  The example arguments are the JAX
    package's (``RandomState(0..3)`` bytes), converted to the port's limbs,
    on the mesh's device.
    """
    bn = default_bn128()
    Kq, Kr = FieldKernels(C.Q, mesh.device), FieldKernels(C.R, mesh.device)
    g1b = G1Batch(Kq)
    msm = ShardedMSMEngine(g1b, bn.g1, C.R, mesh)
    fs = FourStepNTT(mesh, NTTEngine(Kr))
    ndev = mesh.size()
    local = n_points // ndev
    lo = mesh.my_rank() * local
    c = msm.window_bits_for(max(1, local))

    def step(points, windows, a_c, b_c, c_c):
        mine = lambda t: t[:, lo : lo + local].contiguous()
        sums, _bad = msm.window_sums_sharded(tree_map(mine, points), mine(windows), c)
        ae, be, ce = (fs.forward_local(fs.local_rows(x), n_domain) for x in (a_c, b_c, c_c))
        p = Kr.sub(Kr.mul(ae.reshape(LIMBS, -1), be.reshape(LIMBS, -1)), ce.reshape(LIMBS, -1))
        h = fs.inverse_local(p.reshape(ae.shape), n_domain)
        return sums, fs.gather(h)

    def as_limbs(seed, n):
        raw = np.random.RandomState(seed).randint(0, 256, (32, n), dtype=np.int32)
        return torch.from_numpy(jax_to_port(raw)).to(Kr.device)

    pts = g1b.pack([bn.g1.g] * n_points)
    example = (pts, as_limbs(0, n_points), as_limbs(1, n_domain), as_limbs(2, n_domain), as_limbs(3, n_domain))
    return step, example
