"""The card's engines as the hooks of the parity-path protocols.

Counterpart of ``go_snark_study_tpu/models/accel.py``:

  * :func:`enable_gpu_msm` (JAX ``enable_tpu_msm``) installs the Pippenger
    engines (:class:`..ops.msm.MSMEngine`, K1's MSM forms, K2's batch
    inversion) as the MSM backends of the default protocol context, so that
    ``groth16.generate_proofs`` and ``pinocchio.generate_proofs`` run their
    sums Σ wᵢ·Pᵢ on the card;
  * :func:`enable_gpu_setup` (JAX ``enable_tpu_setup``) sends the trusted
    setups' fixed-base commitment batches through
    :class:`..ops.fixed_base.FixedBaseEngine` (K1's per-lane add);
  * :func:`disable_gpu_msm` and :func:`disable_gpu_setup` (JAX
    ``disable_tpu_msm``/``disable_tpu_setup``) restore the host loops.

The results are the same group elements as the host loops give.  A hook
declines (returns None, and the host loop runs) only for a batch below
``min_size``; a failure on the card raises.  ``device=None`` is the card and
raises without one; ``device="cpu"`` runs the kernels' plain versions.  The
engines are built once per device, the sharded ones once per device and
mesh.  With a ``mesh`` (:mod:`..parallel.mesh`), :func:`enable_gpu_msm`
installs :class:`..parallel.sharded_msm.ShardedMSMEngine` pairs: every rank
of the mesh must then run the same protocol calls, as each MSM is a
collective.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..bn128 import constants as C
from ..ops.curve_ops import G1Batch, G2Batch
from ..ops.fixed_base import FixedBaseEngine
from ..ops.limbs import FieldKernels, resolve_device
from ..ops.msm import MSMEngine
from .context import default_context, set_msm_backend

__all__ = [
    "enable_gpu_msm",
    "enable_gpu_setup",
    "disable_gpu_msm",
    "disable_gpu_setup",
    "msm_engines",
    "sharded_msm_engines",
    "fixed_base_engines",
]

_ENGINES: Dict[tuple, Tuple] = {}


def _batches(device):
    dev = resolve_device(device)
    key = ("batch", str(dev))
    if key not in _ENGINES:
        Kq = FieldKernels(C.Q, dev)
        _ENGINES[key] = (G1Batch(Kq), G2Batch(Kq))
    return dev, _ENGINES[key]


def msm_engines(device=None) -> Tuple[MSMEngine, MSMEngine]:
    """The (G1, G2) Pippenger engines of ``device``, built on first use."""
    dev, (g1b, g2b) = _batches(device)
    key = ("msm", str(dev))
    if key not in _ENGINES:
        bn = default_context().bn
        _ENGINES[key] = (MSMEngine(g1b, bn.g1, C.R), MSMEngine(g2b, bn.g2, C.R))
    return _ENGINES[key]


def fixed_base_engines(device=None) -> Tuple[FixedBaseEngine, FixedBaseEngine]:
    """The (G1, G2) fixed-base engines over the generators of ``device``;
    the first use builds their tables on the host."""
    dev, (g1b, g2b) = _batches(device)
    key = ("fb", str(dev))
    if key not in _ENGINES:
        bn = default_context().bn
        _ENGINES[key] = (
            FixedBaseEngine(g1b, bn.g1, bn.g1.g, C.R),
            FixedBaseEngine(g2b, bn.g2, bn.g2.g, C.R),
        )
    return _ENGINES[key]


def sharded_msm_engines(mesh, device=None):
    """The (G1, G2) sharded engines of ``device`` over ``mesh``, built on
    first use."""
    dev, (g1b, g2b) = _batches(device)
    key = ("sharded", str(dev), id(mesh))
    if key not in _ENGINES:
        from ..parallel.sharded_msm import ShardedMSMEngine

        bn = default_context().bn
        _ENGINES[key] = (ShardedMSMEngine(g1b, bn.g1, C.R, mesh), ShardedMSMEngine(g2b, bn.g2, C.R, mesh))
    return _ENGINES[key]


def enable_gpu_msm(device=None, min_size: int = 64, mesh=None) -> None:
    """Run every MSM of at least ``min_size`` points on ``device``, over the
    ranks of ``mesh`` when one is given (JAX: ``enable_tpu_msm``)."""
    g1e, g2e = msm_engines(device) if mesh is None else sharded_msm_engines(mesh, device)

    def g1_backend(points, scalars):
        return g1e.msm(points, scalars) if len(points) >= min_size else None

    def g2_backend(points, scalars):
        return g2e.msm(points, scalars) if len(points) >= min_size else None

    set_msm_backend(g1_backend, g2_backend)


def enable_gpu_setup(device=None, min_size: int = 64) -> None:
    """Run every fixed-base commitment batch of at least ``min_size``
    scalars on ``device`` (JAX: ``enable_tpu_setup``)."""
    fb1, fb2 = fixed_base_engines(device)
    ctx = default_context()
    ctx._batch_g1_backend = lambda s: fb1.batch_mul(s) if len(s) >= min_size else None
    ctx._batch_g2_backend = lambda s: fb2.batch_mul(s) if len(s) >= min_size else None


def disable_gpu_setup() -> None:
    """Back to the host loops for the setups' commitments (JAX:
    ``disable_tpu_setup``)."""
    ctx = default_context()
    ctx._batch_g1_backend = None
    ctx._batch_g2_backend = None


def disable_gpu_msm() -> None:
    """Back to the host loops for the MSMs (JAX: ``disable_tpu_msm``)."""
    set_msm_backend(None, None)
