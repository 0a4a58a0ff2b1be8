"""What bench.py's sizes need of the port, held on the CPU at a small size.

  * The MSM's multi-group plans: a tiled MSM whose windows do not fit one
    group (``group_bytes``), so that they are split into groups and the
    last one is filled with zero windows, as every MSM of a 2^20 proof is.
    Its window sums must be bit for bit the one-group run's, in G1 and in
    G2 on the G1 engine's plans (as the prover shares them), and the JAX
    engine's at the same shape and ``group_bytes``.  The JAX run takes
    minutes of XLA compiles on the CPU, so its window sums are a record,
    ``MSM_RECORD`` (``go_snark_study_tpu_torch/testdata/
    multigroup_msm_window_sums.npz``), rewritten with

        PYTHONPATH=. python tests/test_torch_ladder.py --write-record

    and held to a live JAX run by a ``slow`` test.  The grouping rules
    themselves are compared with the JAX engine's at bench.py's sizes.
  * ``to_affine_tiled``, ``NTTEngine.coset_shift`` / ``ntt_ints`` /
    ``intt_ints``, ``msm.scalars_to_windows`` and ``ops.fields``.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from go_snark_study_tpu_torch.bn128 import constants as C, default_bn128
from go_snark_study_tpu_torch.ops import fields, msm
from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, G2Batch, tree_leaves
from go_snark_study_tpu_torch.ops.limbs import FieldKernels
from go_snark_study_tpu_torch.ops.ntt import NTTEngine

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

# 256 lanes on the tiled path: K = 4 steps of m = 64 lanes a window.  c = 5
# gives 51 windows of 16 magnitudes, every bucket hit by 256 random points,
# so no degeneracy flag fires.  GROUP_BYTES holds 26 windows of G1 (13 of
# G2): 2 groups, the last with 1 zero window, as the 2^20 witness plan.
N_POINTS, TILE_THRESHOLD, TILE_LANES, C_BITS = 256, 128, 64, 5
GROUP_BYTES = 26 * N_POINTS * 3 * 32 * 4
ARITIES = [1, 2]
IDS = ["G1", "G2"]
MSM_RECORD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "go_snark_study_tpu_torch", "testdata", "multigroup_msm_window_sums.npz",
)


def msm_inputs():
    """(multipliers k, scalars): the points are k·G, so the host oracle is
    one scalar multiplication, (Σ k·s)·G."""
    rng = random.Random(9)
    ks = [rng.randrange(1, 1 << 32) for _ in range(N_POINTS)]
    scs = [rng.randrange(C.R) for _ in range(N_POINTS)]
    return ks, scs


def engine(bg, group, group_bytes=GROUP_BYTES):
    return msm.MSMEngine(bg, group, C.R, window_bits=C_BITS, tile_threshold=TILE_THRESHOLD,
                         tile_lanes=TILE_LANES, group_bytes=group_bytes)


def leaves_np(sums):
    return np.stack([t.numpy() for t in tree_leaves(sums)])


@pytest.fixture(scope="module")
def runs():
    """The multi-group G1 run and its plans, the one-group G1 run, G2 on the
    G1 plans and the one-group G2 run: {name: (window sums, flag)}."""
    bn = default_bn128()
    ks, scs = msm_inputs()
    K = FieldKernels(C.Q, "cpu")
    limbs = msm.scalars_to_limbs(scs, C.R, "cpu")
    out = {"ks": ks, "scs": scs}
    for arity, bg, group in ((1, G1Batch(K), bn.g1), (2, G2Batch(K), bn.g2)):
        aff = bg.to_affine(bg.pack([group.mul_scalar(group.g, k) for k in ks]))
        multi, one = engine(bg, group), engine(bg, group, group_bytes=3 << 30)
        if arity == 1:
            plans = out["plans"] = multi.make_plans(limbs, C_BITS)
        out[f"G{arity} multi"] = multi.window_sums_eager(aff, limbs, C_BITS, plans)
        out[f"G{arity} one"] = one.window_sums_eager(aff, limbs, C_BITS)
        out[f"G{arity} engine"] = multi
    return out


def test_plans_are_multi_group(runs):
    """The G1 plans split the 51 windows into 2 groups of 26 and fill the
    last with 1 zero window; the G2 engine's own rule would make 4 groups of
    13, and it runs the G1 plans instead."""
    plans, w = runs["plans"], msm.num_windows(C_BITS)
    lay1, lay2 = runs["G1 engine"].layout(N_POINTS), runs["G2 engine"].layout(N_POINTS)
    assert (lay1["wg"], lay1["wpad"], lay1["groups"]) == (26, 1, 2)
    assert (lay2["wg"], lay2["wpad"], lay2["groups"]) == (13, 1, 4)
    assert plans["mode"] == "tiled" and (plans["wg"], plans["wpad"]) == (26, 1)
    assert len(plans["plans"]) == 2 and w == 51
    for plan in plans["plans"]:
        assert tuple(plan["ord3"].shape) == (lay1["k"], 26, lay1["m"])
        assert plan["comp_dig"].shape == (26, lay1["p_cap"])
    assert bool((plans["plans"][-1]["mag3"][:, 25:] == 0).all())  # the zero window


@pytest.mark.parametrize("arity", ARITIES, ids=IDS)
def test_multi_group_window_sums_equal_one_group(runs, arity):
    (got, gbad), (want, wbad) = runs[f"G{arity} multi"], runs[f"G{arity} one"]
    assert leaves_np(got).shape == (3 * arity, 8, msm.num_windows(C_BITS))
    np.testing.assert_array_equal(leaves_np(got), leaves_np(want))
    assert bool(gbad) == bool(wbad) is False


@pytest.mark.parametrize("arity", ARITIES, ids=IDS)
def test_multi_group_matches_host_oracle(runs, arity):
    bn = default_bn128()
    group = bn.g1 if arity == 1 else bn.g2
    sums, _ = runs[f"G{arity} multi"]
    bg = runs[f"G{arity} engine"].bg
    total = msm.combine_window_sums(group, bg.unpack(sums), C_BITS)
    expect = sum(k * s for k, s in zip(runs["ks"], runs["scs"])) % C.R
    assert group.equal(total, group.mul_scalar(group.g, expect))


def load_record() -> dict:
    with np.load(MSM_RECORD) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arity", ARITIES, ids=IDS)
def test_multi_group_matches_jax_record(runs, arity):
    """Coordinate by coordinate, the JAX engine's window sums at the same
    shape and group_bytes (G2 on the JAX G1 engine's plans)."""
    rec = load_record()
    sums, bad = runs[f"G{arity} multi"]
    got, want = leaves_np(sums), rec[f"g{arity}"]
    assert got.shape == want.shape
    for k in range(got.shape[0]):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"G{arity} window sums, leaf {k}")
    assert bool(bad) == bool(rec[f"g{arity}_bad"])


def test_fallback_engine_keeps_the_grouping(runs):
    eng = msm.MSMEngine(runs["G1 engine"].bg, None, C.R, window_bits=C_BITS, tile_threshold=TILE_THRESHOLD,
                        tile_steps=8, group_bytes=GROUP_BYTES)
    fb = eng.fallback_engine()
    assert fb.complete and (fb.tile_steps, fb.group_bytes) == (8, GROUP_BYTES)
    assert fb.layout(N_POINTS) == eng.layout(N_POINTS)
    assert eng.layout(N_POINTS)["k"] == 8 and eng.pad_quantum(N_POINTS) == 8


@pytest.mark.parametrize(
    "lanes, c, g1, g2",
    [
        ((1 << 14) + 2048, 10, (26, 0, 1), (26, 0, 1)),
        ((1 << 16) + 2048, 11, (24, 0, 1), (24, 0, 1)),
        ((1 << 18) + 2048, 12, (22, 0, 1), (15, 8, 2)),
        ((1 << 20) + 2048, 13, (7, 1, 3), (3, 1, 7)),
        (1 << 20, 13, (8, 4, 3), (4, 0, 5)),
        (1 << 21, 13, (4, 0, 5), (2, 0, 10)),
    ],
)
def test_grouping_at_bench_sizes_matches_jax(lanes, c, g1, g2):
    """The port's window grouping and tiling at the lane counts of bench.py's
    tiers and MSMs, rule for rule the JAX engine's: (wg, wpad, groups) in
    G1 and in G2, and the serial steps of the accumulation."""
    from go_snark_study_tpu.ops import curve_ops as jco
    from go_snark_study_tpu.ops import msm as jmsm
    from go_snark_study_tpu.ops.fields import fq_kernels as jax_fq

    K = FieldKernels(C.Q, "cpu")
    for arity, bg, jbg, want in ((1, G1Batch(K), jco.G1Batch(jax_fq()), g1), (2, G2Batch(K), jco.G2Batch(jax_fq()), g2)):
        eng, jeng = msm.MSMEngine(bg, None, C.R), jmsm.MSMEngine(jbg, None, C.R)
        lay = eng.layout(lanes)
        w = jmsm.num_windows(c)
        jwg = jeng._group_size(lanes, w)
        assert (lay["c"], lay["w"]) == (jeng.window_bits_for(lanes), w) == (c, w)
        assert (lay["wg"], lay["wpad"], lay["groups"]) == (jwg, (-w) % jwg, -(-w // jwg)) == want
        assert (lay["k"], lay["m"]) == jeng._tile_split(lanes)
        assert eng.pad_quantum(lanes) == jeng.pad_quantum(lanes)


@pytest.mark.parametrize("arity", ARITIES, ids=IDS)
def test_to_affine_tiled_is_to_affine(arity):
    """Bit for bit over a ragged lane count, identity lanes included."""
    K = FieldKernels(C.Q, "cpu")
    bg = G1Batch(K) if arity == 1 else G2Batch(K)
    gen = torch.Generator().manual_seed(arity)
    n, tile = 150, 64

    def fq():
        x = torch.randint(0, 1 << 32, (8, n), generator=gen, dtype=torch.int64)
        x[7] %= C.Q >> 224
        return x.to(torch.int32)

    coord = (lambda: fq()) if arity == 1 else (lambda: (fq(), fq()))
    x, y, z = coord(), coord(), coord()
    ident = (torch.arange(n) % 9 == 4)[None]
    z = torch.where(ident, 0, z) if arity == 1 else tuple(torch.where(ident, 0, t) for t in z)
    p = (x, y, z)
    got, want = bg.to_affine_tiled(p, tile=tile), bg.to_affine(p)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    assert bool((tree_leaves(got)[-1][:, ident[0]] == 0).all())  # identities -> (0, 0, 0)
    for g, w in zip(tree_leaves(bg.to_affine_tiled(p)), tree_leaves(want)):  # the default tile: one call
        assert torch.equal(g, w)


def test_coset_shift_and_host_ntts():
    """At 2^6: ntt_ints against a naive DFT over Fr, intt_ints(ntt_ints(v))
    == v, and coset_shift against g^±i on the host."""
    n, r = 1 << 6, C.R
    ntt = NTTEngine(FieldKernels(C.R, "cpu"))
    rng = random.Random(3)
    v = [rng.randrange(r) for _ in range(n)]
    w = ntt.root_of_unity(n)
    evals = ntt.ntt_ints(v)
    assert evals == [sum(c * pow(w, i * j, r) for j, c in enumerate(v)) % r for i in range(n)]
    assert ntt.intt_ints(evals) == v
    x = ntt.K.pack(v)
    for g in (5, 7):
        for inverse in (False, True):
            gg = pow(g, -1, r) if inverse else g
            want = [c * pow(gg, i, r) % r for i, c in enumerate(v)]
            assert ntt.K.unpack(ntt.coset_shift(x, g, inverse)) == want
    powers = ntt.coset_powers(n, 5, True)
    assert torch.equal(ntt.coset_shift(x, inverse=True, powers=powers), ntt.coset_shift(x, 5, True))


def test_scalars_to_windows_is_jax_digits():
    from go_snark_study_tpu.ops import msm as jmsm

    rng = random.Random(4)
    scs = [0, 1, C.R - 1] + [rng.randrange(C.R) for _ in range(61)]
    got = msm.scalars_to_windows(scs, C.R, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmsm.scalars_to_windows(scs, C.R)))


def test_field_kernels_one_per_device(monkeypatch):
    fq, fr = fields.fq_kernels("cpu"), fields.fr_kernels("cpu")
    assert fq is fields.fq_kernels(torch.device("cpu")) and fr is fields.fr_kernels("cpu")
    assert (fq.p, fr.p) == (C.Q, C.R) and fq.device.type == fr.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (fields.fq_kernels, fields.fr_kernels):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def jax_record() -> dict:
    """The JAX engine's window sums for ``msm_inputs`` at this file's shape
    and group_bytes: G1, and G2 on the G1 engine's plans, as (3·arity, 8, W)
    limbs in the port's layout, with their flags."""
    from go_snark_study_tpu.ops import curve_ops as jco
    from go_snark_study_tpu.ops import msm as jmsm
    from go_snark_study_tpu.ops.fields import fq_kernels as jax_fq
    import jax

    from go_snark_study_tpu_torch.interop import jax_to_port

    bn = default_bn128()
    ks, scs = msm_inputs()
    limbs = jmsm.scalars_to_limbs(scs, C.R)
    out, plans = {}, None
    for arity, jbg, group in ((1, jco.G1Batch(jax_fq()), bn.g1), (2, jco.G2Batch(jax_fq()), bn.g2)):
        eng = jmsm.MSMEngine(jbg, group, C.R, window_bits=C_BITS, tile_threshold=TILE_THRESHOLD,
                             tile_lanes=TILE_LANES, group_bytes=GROUP_BYTES)
        if plans is None:
            plans = eng.make_plans(limbs, C_BITS)
            assert (plans["wg"], plans["wpad"]) == (26, 1)
        aff = jbg.to_affine(jbg.pack([group.mul_scalar(group.g, k) for k in ks]))
        sums, bad = eng.window_sums_eager(aff, limbs, C_BITS, plans)
        out[f"g{arity}"] = np.stack([jax_to_port(np.asarray(leaf)) for leaf in jax.tree.leaves(sums)])
        out[f"g{arity}_bad"] = np.array(bool(np.asarray(bad)))
    return out


@pytest.mark.slow
def test_msm_record_is_live_jax_output():
    """The record is JAX's output today.  If this fails after a deliberate
    change to the JAX engine, rewrite the record with
    ``PYTHONPATH=. python tests/test_torch_ladder.py --write-record``."""
    live, rec = jax_record(), load_record()
    assert set(live) == set(rec)
    for k in live:
        np.testing.assert_array_equal(live[k], rec[k], err_msg=k)


if __name__ == "__main__":  # pragma: no cover - run by hand, needs JAX
    if "--write-record" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import conftest  # noqa: F401  (the CPU platform only)

        rec = jax_record()
        np.savez_compressed(MSM_RECORD, **rec)
        print("wrote", MSM_RECORD, {k: v.shape for k, v in rec.items()})
