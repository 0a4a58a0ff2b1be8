"""K1's plain version held against the JAX package's group-law formulas
(the functions its Pallas point kernel traces), bit for bit, for G1 and G2,
all four forms, with identity, equal and inverse lanes mixed in; the
flagged forms must flag the same lanes.  Also the port's fixed-base engine
and affine normalisation against the host curve.
"""

import random

import jax
import numpy as np
import pytest
import torch

from go_snark_study_tpu.ops import curve_ops as jco
from go_snark_study_tpu.ops.fields import fq_kernels as jax_fq_kernels
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.bn128 import default_bn128
from go_snark_study_tpu_torch.interop import jax_to_port, port_to_jax
from go_snark_study_tpu_torch.ops import point_add as pa
from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, G2Batch
from go_snark_study_tpu_torch.ops.limbs import FieldKernels

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

LANES = 12


def _points(group, seed, affine):
    """Host points with edge lanes: identities (lanes 0-2), and lanes 3-5
    that the caller pairs as equal / inverse / equal (different z)."""
    rng = random.Random(seed)
    out = []
    for _ in range(LANES):
        p = group.mul_scalar(group.g, rng.randrange(1, C.R))
        if affine:
            a = group.affine(p)
            p = (a[0], a[1], 1) if len(a) == 2 else a
        out.append(p)
    return out


def _pair(group, mixed):
    p1, p2 = _points(group, 1, False), _points(group, 2, mixed)
    zero = tuple(0 if isinstance(c, int) else (0, 0) for c in group.zero())
    p1[0] = zero
    p2[1] = zero
    p1[2] = p2[2] = zero
    q = group.mul_scalar(group.g, 77)
    aff = group.affine(q)
    aff = (aff[0], aff[1], 1) if len(aff) == 2 else aff
    q_other_z = aff if mixed else group.add(group.mul_scalar(group.g, 70), group.mul_scalar(group.g, 7))
    p1[3], p2[3] = q, q_other_z  # equal
    p1[4], p2[4] = q, group.neg(q_other_z)  # inverse
    p1[5], p2[5] = aff, q_other_z  # equal, p1 with z = 1
    return p1, p2


def _to_jax(port_pt):
    if isinstance(port_pt, tuple):
        return tuple(_to_jax(c) for c in port_pt)
    return jax.numpy.asarray(port_to_jax(port_pt))


def _leaves(pt):
    if isinstance(pt, tuple):
        return [leaf for c in pt for leaf in _leaves(c)]
    return [pt]


class _JitField:
    """JAX ``FieldKernels`` with each primitive jitted on its own: the
    formulas then run op by op on compiled primitives — the same values as
    tracing a whole formula, without an XLA compile per formula."""

    def __init__(self, K):
        self._mul_impl = jax.jit(K._mul_xla)
        self._add_impl = jax.jit(K._add_impl)
        self._sub_impl = jax.jit(K._sub_impl)
        self._neg_impl = jax.jit(K._neg_impl)
        self.is_zero = jax.jit(K.is_zero)
        self.equal = jax.jit(K.equal)


@pytest.fixture(scope="module")
def kernels():
    return _JitField(jax_fq_kernels()), FieldKernels(C.Q, "cpu")


@pytest.mark.parametrize("arity", [1, 2], ids=["G1", "G2"])
@pytest.mark.parametrize("form", list(pa.FORMS))
def test_plain_point_add_matches_jax_formula(kernels, form, arity):
    JK, K = kernels
    bn = default_bn128()
    group = bn.g1 if arity == 1 else bn.g2
    bg = G1Batch(K) if arity == 1 else G2Batch(K)
    jF = jco.BatchFq(JK) if arity == 1 else jco.BatchFq2(JK)
    _, name, flagged = pa.FORMS[form]
    p1, p2 = _pair(group, form.startswith("madd"))
    t1, t2 = bg.pack(p1), bg.pack(p2)

    got = pa.point_add(form, arity, t1, t2)  # CPU tensors: the plain version
    want = getattr(jco, name)(jF, _to_jax(t1), _to_jax(t2))
    if flagged:
        (got, gbad), (want, wbad) = got, want
        np.testing.assert_array_equal(gbad.numpy(), np.asarray(wbad))
        assert gbad[3:6].all() and not gbad[:3].any()
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(port_to_jax(g), np.asarray(w))
    if not flagged:  # the complete forms are the group law
        for k, pt in enumerate(bg.unpack(got)):
            assert group.equal(pt, group.add(p1[k], p2[k])), k


def test_fixed_base_and_affine_match_host():
    from go_snark_study_tpu_torch.ops.fixed_base import FixedBaseEngine

    bn = default_bn128()
    K = FieldKernels(C.Q, "cpu")
    rng = random.Random(9)
    scalars = [0, 1, 2, 255, 256, C.R - 1] + [rng.randrange(C.R) for _ in range(6)]
    for group, bg in ((bn.g1, G1Batch(K)), (bn.g2, G2Batch(K))):
        fb = FixedBaseEngine(bg, group, group.g, C.R)
        got = fb.batch_mul(scalars)
        for s, p in zip(scalars, got):
            assert group.equal(p, group.mul_scalar(group.g, s))
        aff = bg.unpack(bg.to_affine(bg.pack(got)))
        for s, p in zip(scalars, aff):
            want = group.mul_scalar(group.g, s)
            assert group.equal(p, want) if s else p[2] in (0, (0, 0))
            if s:
                assert p[2] in (1, (1, 0))


def test_jax_points_convert_to_the_port():
    """A JAX-packed point array reads back as the same host points."""
    bn = default_bn128()
    pts = _points(bn.g1, 4, False)
    jax_pt = jco.G1Batch(jax_fq_kernels()).pack(pts)
    port_pt = tuple(torch.from_numpy(jax_to_port(np.asarray(c))) for c in jax_pt)
    assert G1Batch(FieldKernels(C.Q, "cpu")).unpack(port_pt) == pts
