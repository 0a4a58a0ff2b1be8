"""The port's Pippenger MSM held against the JAX package's ``MSMEngine``:
signed window digits bit for bit, window sums as group elements (JAX runs
live at 128 points, the small path), and the tiled path (the one a 2^16
proof takes) against the host curve with a lowered tile threshold.
"""

import random

import jax
import numpy as np
import pytest
import torch

from go_snark_study_tpu.ops import curve_ops as jco
from go_snark_study_tpu.ops import msm as jmsm
from go_snark_study_tpu.ops.fields import fq_kernels as jax_fq_kernels
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.bn128 import default_bn128
from go_snark_study_tpu_torch.ops import msm
from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, G2Batch
from go_snark_study_tpu_torch.ops.limbs import FieldKernels

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)


def _scalars(seed, n):
    rng = random.Random(seed)
    return [0, 1, C.R - 1, (1 << 253) + 5] + [rng.randrange(C.R) for _ in range(n - 4)]


@pytest.mark.parametrize("c", [5, 8, 11, 13])
def test_signed_digits_match_jax(c):
    scs = _scalars(c, 200)
    want = np.asarray(jmsm.signed_digits_from_limbs(jmsm.scalars_to_limbs(scs, C.R), c))
    got = msm.signed_digits_from_limbs(msm.scalars_to_limbs(scs, C.R, "cpu"), c)
    np.testing.assert_array_equal(got.numpy(), want)
    # the signed digits re-assemble the scalar
    for k, s in enumerate(scs[:20]):
        assert sum(int(d) << (c * w) for w, d in enumerate(got[:, k].tolist())) == s


def test_window_sums_match_jax_small_path():
    bn = default_bn128()
    rng = random.Random(11)
    n = 128
    pts = [bn.g1.mul_scalar(bn.g1.g, rng.randrange(1, C.R)) for _ in range(n)]
    scs = _scalars(12, n)
    # c = 5: every bucket of every window is hit, so the incomplete adds
    # never degenerate and both engines return their fast-path sums
    c = 5

    jbg = jco.G1Batch(jax_fq_kernels())
    jeng = jmsm.MSMEngine(jbg, bn.g1, C.R)
    jsums, jbad = jeng.window_sums_eager(
        jbg.to_affine(jbg.pack(pts)), jmsm.scalars_to_limbs(scs, C.R), c
    )
    bg = G1Batch(FieldKernels(C.Q, "cpu"))
    eng = msm.MSMEngine(bg, bn.g1, C.R)
    sums, bad = eng.window_sums_eager(
        bg.to_affine(bg.pack(pts)), msm.scalars_to_limbs(scs, C.R, "cpu"), c
    )
    assert not bool(np.asarray(jbad)) and not bool(bad)
    got, want = bg.unpack(sums), jbg.unpack(jsums)
    assert len(got) == len(want) == msm.num_windows(c)
    for g, w in zip(got, want):
        assert bn.g1.equal(g, w)
    total = msm.combine_window_sums(bn.g1, got, c)
    expect = bn.g1.zero()
    for p, s in zip(pts, scs):
        expect = bn.g1.add(expect, bn.g1.mul_scalar(p, s))
    assert bn.g1.equal(total, expect)


@pytest.mark.parametrize("arity", [1, 2], ids=["G1", "G2"])
def test_tiled_path_matches_host(arity):
    """The tiled pipeline (plan, K-step apply, compaction, segmented scan,
    bucket reduction) with repeated points, so that the degeneracy flag
    fires and the complete-formula re-run is exercised too."""
    bn = default_bn128()
    group = bn.g1 if arity == 1 else bn.g2
    K = FieldKernels(C.Q, "cpu")
    bg = G1Batch(K) if arity == 1 else G2Batch(K)
    rng = random.Random(13 + arity)
    base = [group.mul_scalar(group.g, rng.randrange(1, C.R)) for _ in range(6)]
    n = 200 if arity == 1 else 96
    pts = [base[k % 6] for k in range(n)]
    scs = [rng.randrange(C.R) for _ in range(n)]
    eng = msm.MSMEngine(bg, group, C.R, window_bits=8, tile_threshold=64, tile_lanes=64)
    got = eng.msm(pts, scs)
    expect = group.zero()
    for b in range(6):
        expect = group.add(expect, group.mul_scalar(base[b], sum(scs[b::6]) % C.R))
    assert group.equal(got, expect)
    assert eng.fallback_hits == 1
