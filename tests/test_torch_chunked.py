"""The MSM engine's chunk families, held against the JAX package on the CPU.

  * The chunk rules (``_chunk_for``, ``window_bits_for``, ``pad_quantum``,
    ``_group_size`` at the chunk width) against the JAX engine's at
    bench.py's lane counts, in G1 and in G2 (no small family there).
  * A chunked engine at a small scale (``CHUNK`` lanes a chunk, c = 6):
    identity pad lanes, equal-digit runs that cross a chunk boundary,
    results equal to the host oracle, G2 on G1's chunk plan, a planted
    degenerate case whose flag fires and whose complete re-run keeps the
    chunking.  The window sums are bit for bit the JAX chunked engine's.
    The JAX run takes minutes of XLA compiles on the CPU, so its window
    sums are a record, ``CHUNK_RECORD`` (``go_snark_study_tpu_torch/
    testdata/chunked_msm_window_sums.npz``), rewritten with

        PYTHONPATH=. python tests/test_torch_chunked.py --write-record

    and held to a live JAX run by a ``slow`` test.
  * ``dry_shape_check`` against the JAX function's live dict.
  * The batch groups' ``madd``/``madd_flagged``/``jadd_flagged``/
    ``neg_y_where`` and ``MSMEngine.window_sums_device``.
  * One ``FastGroth16`` prove with small chunked engines (G2 on its own
    plan), equal to the JAX record of ``tests/test_torch_prover.py``.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from go_snark_study_tpu_torch.bn128 import constants as C, default_bn128
from go_snark_study_tpu_torch.ops import curve_ops as co
from go_snark_study_tpu_torch.ops import msm
from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, G2Batch, tree_leaves
from go_snark_study_tpu_torch.ops.limbs import FieldKernels

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

# N_POINTS pad to 3 chunks of CHUNK lanes (84 identity pad lanes); each
# chunk is K = 4 steps of m = 32 lanes a window, 43 windows of c = 6
N_POINTS, CHUNK, C_BITS, TILE_THRESHOLD, TILE_LANES = 300, 128, 6, 64, 32
N_HEAVY = 200  # scalars with one digit in every window: runs across chunk 0 and 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_RECORD = os.path.join(ROOT, "go_snark_study_tpu_torch", "testdata", "chunked_msm_window_sums.npz")
GOLDEN = os.path.join(ROOT, "go_snark_study_tpu_torch", "testdata", "groth16_mul_chain30.npz")


def engine(bg, group, **kw):
    return msm.MSMEngine(bg, group, C.R, window_bits=C_BITS, tile_threshold=TILE_THRESHOLD, tile_lanes=TILE_LANES,
                         chunk_lanes=CHUNK, **kw)


def heavy_scalar() -> int:
    return int.from_bytes(bytes([0x2A] * 32), "little") % C.R


def msm_inputs():
    """{case: (multipliers k, scalars)}; the points are k·G.  ``random``:
    distinct points and random scalars; ``heavy``: JAX's chunk-boundary
    case, eight distinct points repeated (so that equal points meet and the
    flag fires) and one digit in every window of the first N_HEAVY scalars."""
    rng = random.Random(9)
    ks = [rng.randrange(1, 1 << 32) for _ in range(N_POINTS)]
    scs = [rng.randrange(C.R) for _ in range(N_POINTS)]
    heavy = [heavy_scalar()] * N_HEAVY + [rng.randrange(C.R) for _ in range(N_POINTS - N_HEAVY)]
    return {"random": (ks, scs), "heavy": ([(i % 8) + 1 for i in range(N_POINTS)], heavy)}


def leaves_np(sums):
    return np.stack([t.numpy() for t in tree_leaves(sums)])


def oracle(group, ks, scs):
    return group.mul_scalar(group.g, sum(k * s for k, s in zip(ks, scs)) % C.R)


# ---------------------------------------------------------------------------
# (a) the chunk rules at bench.py's lane counts
# ---------------------------------------------------------------------------
BENCH_LANES = [8191, 8192, (1 << 14) + 3, 1 << 15, (1 << 15) + 1, (1 << 16) + 3, (1 << 18) + 3, 1 << 20,
               (1 << 20) + 3, 9 << 17, 1 << 21]


@pytest.mark.parametrize("arity", [1, 2], ids=["G1", "G2"])
def test_chunk_rules_match_jax(arity):
    """JAX's accelerator configuration: big chunks of 2^17 at c = 13, in G1
    small chunks of 2^14 at c = 11 up to 2^15 lanes, in G2 none."""
    from go_snark_study_tpu.ops import curve_ops as jco
    from go_snark_study_tpu.ops import msm as jmsm
    from go_snark_study_tpu.ops.fields import fq_kernels as jax_fq

    small = (1 << 14) if arity == 1 else 0
    K = FieldKernels(C.Q, "cpu")
    bg, jbg = (G1Batch(K), jco.G1Batch(jax_fq())) if arity == 1 else (G2Batch(K), jco.G2Batch(jax_fq()))
    eng = msm.MSMEngine(bg, None, C.R, chunk_lanes=1 << 17, small_chunk_lanes=small)
    jeng = jmsm.MSMEngine(jbg, None, C.R, chunk_lanes=1 << 17, small_chunk_lanes=small)
    assert (eng.chunk_lanes, eng.small_chunk_lanes, eng.small_chunk_max) == \
        (jeng.chunk_lanes, jeng.small_chunk_lanes, jeng.small_chunk_max)
    for n in BENCH_LANES:
        ch = eng._chunk_for(n)
        assert ch == jeng._chunk_for(n) and eng._canonical(n) == jeng._canonical(n), n
        c = eng.window_bits_for(n)
        assert c == jeng.window_bits_for(n) and eng.pad_quantum(n) == jeng.pad_quantum(n), n
        span = ch or n
        w = msm.num_windows(c)
        assert eng._group_size(span, w) == jeng._group_size(span, w), n
        lay = eng.layout(n)
        if n < eng.tile_threshold:
            assert lay["mode"] == "small" and ch is None
            continue
        assert lay["mode"] == ("chunk" if ch else "tiled") and lay["wg"] == eng._group_size(span, w)
        if ch:
            assert (lay["span"], lay["chunks"], lay["badds"]) == (ch, -(-n // ch), -(-n // ch) - 1)
            assert (lay["k"], lay["m"]) == jeng._tile_split(ch)
    lay = eng.layout(9 << 17)  # the 2^20 tier's chunk-padded witness
    assert (lay["c"], lay["chunks"], lay["groups"], lay["k"], lay["m"], lay["p_cap"], lay["seg_steps"]) == \
        (13, 9, 1, 64, 2048, 6272, 13)
    if arity == 1:
        lay = eng.layout(1 << 15)  # the 2^14 tier's witness: 2 small chunks
        assert (lay["c"], lay["span"], lay["chunks"], lay["k"], lay["p_cap"], lay["seg_steps"]) == \
            (11, 1 << 14, 2, 8, 3200, 12)


def test_default_engine_is_unchunked():
    """chunk_lanes=None keeps the unchunked path on every device; the
    fallback twin carries the chunk parameters."""
    K = FieldKernels(C.Q, "cpu")
    eng = msm.MSMEngine(G1Batch(K), None, C.R)
    assert eng.chunk_lanes is None and eng._chunk_for(1 << 20) is None
    assert eng.layout(1 << 20)["mode"] == "tiled" and eng.window_bits_for(1 << 18) == 12
    chunked = msm.MSMEngine(G1Batch(K), None, C.R, chunk_lanes=512, small_chunk_lanes=128, small_chunk_max=300)
    fb = chunked.fallback_engine()
    assert fb.complete and (fb.chunk_lanes, fb.small_chunk_lanes, fb.small_chunk_max) == (512, 128, 300)
    assert fb.layout(9000) == chunked.layout(9000)


# ---------------------------------------------------------------------------
# (b) a chunked engine at a small scale
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs():
    """{name: (window sums, flag)}: the random case in G1 with its plans,
    G2 on those plans, and the heavy case in G1 with its complete re-run."""
    bn = default_bn128()
    K = FieldKernels(C.Q, "cpu")
    inputs = msm_inputs()
    out = {"inputs": inputs}
    ks, scs = inputs["random"]
    limbs = msm.scalars_to_limbs(scs, C.R, "cpu")
    plans = None
    for arity, bg, group in ((1, G1Batch(K), bn.g1), (2, G2Batch(K), bn.g2)):
        eng = out[f"G{arity} engine"] = engine(bg, group)
        if plans is None:
            plans = out["plans"] = eng.make_plans(limbs, C_BITS)
        aff = bg.to_affine(bg.pack([group.mul_scalar(group.g, k) for k in ks]))
        out[f"g{arity}"] = eng.window_sums_eager(aff, limbs, C_BITS, plans)
    ks, scs = inputs["heavy"]
    eng = out["G1 engine"]
    bg = eng.bg
    aff = bg.to_affine(bg.pack([bn.g1.mul_scalar(bn.g1.g, k) for k in ks]))
    limbs = msm.scalars_to_limbs(scs, C.R, "cpu")
    out["deg"] = eng.window_sums_eager(aff, limbs, C_BITS)
    out["deg_complete"] = eng.fallback_engine().window_sums_eager(aff, limbs, C_BITS)
    return out


def test_chunk_plans(runs):
    """3 chunks of 128 lanes (the last with 84 identity pad lanes), one
    window group each, scalars zero-padded to the span."""
    plans, eng = runs["plans"], runs["G1 engine"]
    assert plans["mode"] == "chunk" and (plans["n"], plans["span"], plans["wg"], plans["wpad"]) == \
        (N_POINTS, CHUNK, 43, 0)
    assert len(plans["chunks"]) == 3 and all(len(g) == 1 for g in plans["chunks"])
    lay = eng.layout(N_POINTS)
    assert (lay["chunks"], lay["k"], lay["m"], lay["badds"]) == (3, 4, 32, 2)
    for (plan,) in plans["chunks"]:
        assert tuple(plan["ord3"].shape) == (4, 43, 32) and plan["comp_dig"].shape == (43, lay["p_cap"])
    last = plans["chunks"][-1][0]
    pad = 3 * CHUNK - N_POINTS
    assert int((last["mag3"] == 0).sum()) >= 43 * pad  # the zero-padded lanes' digits


@pytest.mark.parametrize("arity", [1, 2], ids=["G1", "G2 on the G1 plan"])
def test_chunked_matches_host_oracle(runs, arity):
    bn = default_bn128()
    group = bn.g1 if arity == 1 else bn.g2
    sums, bad = runs[f"g{arity}"]
    assert leaves_np(sums).shape == (3 * arity, 8, msm.num_windows(C_BITS)) and not bool(bad)
    total = msm.combine_window_sums(group, runs[f"G{arity} engine"].bg.unpack(sums), C_BITS)
    assert group.equal(total, oracle(group, *runs["inputs"]["random"]))


def load_record() -> dict:
    with np.load(CHUNK_RECORD) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ["g1", "g2", "deg", "deg_complete"])
def test_chunked_matches_jax_record(runs, name):
    """Coordinate by coordinate, the JAX chunked engine's window sums, with
    its flag: G1, G2 on the JAX G1 plan, the heavy case incomplete (flag
    fired) and its complete re-run."""
    rec = load_record()
    sums, bad = runs[name]
    got, want = leaves_np(sums), rec[name]
    assert got.shape == want.shape
    for k in range(got.shape[0]):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} window sums, leaf {k}")
    assert bool(bad) == bool(rec[f"{name}_bad"])


def test_degenerate_rerun_keeps_chunking(runs):
    """The heavy case's equal points fire the flag; the complete twin (what
    window_sums_checked re-runs) chunks alike, its flag stays clear, and its
    result is the host oracle's."""
    bn = default_bn128()
    eng = runs["G1 engine"]
    assert bool(runs["deg"][1]) and not bool(runs["deg_complete"][1])
    fb = eng.fallback_engine()
    assert fb.chunk_lanes == CHUNK and fb.layout(N_POINTS) == eng.layout(N_POINTS)
    total = msm.combine_window_sums(bn.g1, eng.bg.unpack(runs["deg_complete"][0]), C_BITS)
    assert bn.g1.equal(total, oracle(bn.g1, *runs["inputs"]["heavy"]))


# ---------------------------------------------------------------------------
# (c) dry_shape_check against the JAX function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_log2, mesh_shape", [(22, (2, 8)), (14, (1, 2))])
def test_dry_shape_check_matches_jax(n_log2, mesh_shape):
    from go_snark_study_tpu.parallel.sharded_prover import dry_shape_check as jax_dry
    from go_snark_study_tpu_torch.parallel.sharded_prover import dry_shape_check

    assert dry_shape_check(n_log2, mesh_shape) == jax_dry(n_log2, mesh_shape)


# ---------------------------------------------------------------------------
# (d) the batch groups' new methods and window_sums_device
# ---------------------------------------------------------------------------
def rand_limbs(gen, n):
    x = torch.randint(0, 1 << 32, (8, n), generator=gen, dtype=torch.int64)
    x[7] %= C.Q >> 224
    return x.to(torch.int32)


@pytest.mark.parametrize("arity", [1, 2], ids=["G1", "G2"])
def test_batch_group_methods_are_the_formulas(arity):
    """madd, madd_flagged, jadd_flagged and neg_y_where against the
    curve_ops formulas over the same field, with equal and identity lanes
    planted so that the flags fire and the identity cases run."""
    K = FieldKernels(C.Q, "cpu")
    bg = G1Batch(K) if arity == 1 else G2Batch(K)
    F = co.BatchFq(K) if arity == 1 else co.BatchFq2(K)
    gen = torch.Generator().manual_seed(arity)
    n = 24
    coord = (lambda: rand_limbs(gen, n)) if arity == 1 else (lambda: (rand_limbs(gen, n), rand_limbs(gen, n)))
    p = bg.to_affine((coord(), coord(), coord()))
    q = bg.to_affine((coord(), coord(), coord()))
    jac = (coord(), coord(), coord())
    same = (torch.arange(n) % 5 == 0)[None]
    q = co.tree_map(lambda a, b: torch.where(same, a, b), p, q)  # every fifth lane: p == q
    ident = (torch.arange(n) % 7 == 3)[None]
    q = co.tree_map(lambda a: torch.where(ident, 0, a), q)  # identity lanes
    eq = lambda a, b: all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert eq(bg.madd(jac, q), co.jacobian_add_mixed(F, jac, q))
    for got, fn, a in ((bg.madd_flagged(p, q), co.jacobian_add_mixed_incomplete, p),
                       (bg.jadd_flagged(jac, q), co.jacobian_add_incomplete, jac),
                       (bg.jadd_flagged(p, q), co.jacobian_add_incomplete, p)):
        want = fn(F, a, q)
        assert eq(got[0], want[0]) and torch.equal(got[1], want[1]) and got[1].shape == (n,)
    assert bool(bg.madd_flagged(p, q)[1].any())  # the planted equal lanes
    mask = torch.arange(n) % 3 == 1
    got = bg.neg_y_where(p, mask)
    want_y = co.tree_map(lambda y, ny: torch.where(mask[None], ny, y), p[1], F.neg(p[1]))
    assert eq(got[0], p[0]) and eq(got[2], p[2]) and eq(got[1], want_y)


def test_window_sums_device_is_unchunked():
    """On a chunked engine, window_sums_device runs the unchunked tiled
    pipeline: bit for bit an unchunked engine's window_sums_eager (held to
    the oracle by the tiled path's own tests), where window_sums_eager
    chunks (2 chunks of 128)."""
    bn = default_bn128()
    K = FieldKernels(C.Q, "cpu")
    bg = G1Batch(K)
    rng = random.Random(11)
    n = 2 * CHUNK
    scs = [rng.randrange(C.R) for _ in range(n)]
    aff = bg.to_affine(bg.pack([bn.g1.mul_scalar(bn.g1.g, rng.randrange(1, 1 << 32)) for _ in range(n)]))
    limbs = msm.scalars_to_limbs(scs, C.R, "cpu")
    chunked = engine(bg, bn.g1)
    unchunked = msm.MSMEngine(bg, bn.g1, C.R, window_bits=C_BITS, tile_threshold=TILE_THRESHOLD,
                              tile_lanes=TILE_LANES)
    assert chunked.layout(n)["chunks"] == 2 and unchunked.layout(n)["mode"] == "tiled"
    (dev, dbad), (want, wbad) = chunked.window_sums_device(aff, limbs, C_BITS), \
        unchunked.window_sums_eager(aff, limbs, C_BITS)
    np.testing.assert_array_equal(leaves_np(dev), leaves_np(want))
    assert bool(dbad) == bool(wbad)


# ---------------------------------------------------------------------------
# (e) one FastGroth16 prove with small chunked engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chunked_prove():
    """mul_chain_r1cs(30, seed=1), random.Random(42): the golden record's
    inputs, on engines chunked at this size.  G1: a small family of 32
    lanes (33 signals: 2 chunks) at c = 8; G2: no small family, one 64-lane
    chunk at c = 9, so the prover builds G2's own plan."""
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    fast = FastGroth16(device="cpu")
    bn = fast.ctx.bn
    kw = dict(tile_threshold=16, tile_lanes=8, chunk_lanes=64)
    fast.msm_g1 = msm.MSMEngine(fast.g1b, bn.g1, C.R, window_bits=8, small_chunk_lanes=32, small_chunk_max=64, **kw)
    fast.msm_g2 = msm.MSMEngine(fast.g2b, bn.g2, C.R, window_bits=9, small_chunk_lanes=0, **kw)
    r1cs = mul_chain_r1cs(30, seed=1)
    rng = random.Random(42)
    setup = fast.setup(r1cs, rng=rng)
    plans = []
    make_plans = fast.msm_g2.make_plans
    fast.msm_g2.make_plans = lambda *a, **k: plans.append(a[1]) or make_plans(*a, **k)
    proof = fast.prove(r1cs, setup.pk, rng=rng)
    return fast, r1cs, setup, proof, plans


def test_chunked_prove_matches_jax_record(chunked_prove):
    from go_snark_study_tpu_torch.models.groth16 import verify_proof

    fast, r1cs, setup, proof, g2_plans = chunked_prove
    dpk = setup.pk._device
    # the key is padded to the G1 chunk: 33 signals -> 64 lanes, 2 chunks
    assert (dpk.m_pad, dpk.mp_pad, dpk.n_pad) == (64, 32, 32)
    assert fast.msm_g1.layout(dpk.m_pad)["chunks"] == 2 and fast.msm_g2.layout(dpk.m_pad)["span"] == 64
    assert g2_plans and set(g2_plans) == {9}  # G2 built its own plan at its own width
    with np.load(GOLDEN) as z:
        want = json.loads(str(z["meta"]))["proof"]
    bn = fast.ctx.bn
    g1 = lambda p: tuple(int(c) for c in p)
    g2 = lambda p: tuple((int(c[0]), int(c[1])) for c in p)
    assert bn.g1.equal(proof.pi_a, g1(want["pi_a"]))
    assert bn.g2.equal(proof.pi_b, g2(want["pi_b"]))
    assert bn.g1.equal(proof.pi_c, g1(want["pi_c"]))
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    assert verify_proof(setup.vk, proof, publics)
    assert not verify_proof(setup.vk, proof, [publics[0] + 1])


# ---------------------------------------------------------------------------
# the JAX record
# ---------------------------------------------------------------------------
def jax_record() -> dict:
    """The JAX chunked engine's window sums for ``msm_inputs`` at this
    file's shape: the random case in G1, and in G2 on the G1 plans; the
    heavy case in G1 (flag fired) and its complete re-run; each as
    (3·arity, 8, W) limbs in the port's layout, with its flag."""
    import jax

    from go_snark_study_tpu.ops import curve_ops as jco
    from go_snark_study_tpu.ops import msm as jmsm
    from go_snark_study_tpu.ops.fields import fq_kernels as jax_fq
    from go_snark_study_tpu_torch.interop import jax_to_port

    bn = default_bn128()
    inputs = msm_inputs()
    conv = lambda sums: np.stack([jax_to_port(np.asarray(leaf)) for leaf in jax.tree.leaves(sums)])
    mk = lambda jbg, group: jmsm.MSMEngine(jbg, group, C.R, window_bits=C_BITS, tile_threshold=TILE_THRESHOLD,
                                           tile_lanes=TILE_LANES, chunk_lanes=CHUNK)
    out, plans = {}, None
    ks, scs = inputs["random"]
    limbs = jmsm.scalars_to_limbs(scs, C.R)
    for arity, jbg, group in ((1, jco.G1Batch(jax_fq()), bn.g1), (2, jco.G2Batch(jax_fq()), bn.g2)):
        eng = mk(jbg, group)
        if plans is None:
            plans = eng.make_plans(limbs, C_BITS)
            assert plans["mode"] == "chunk" and len(plans["chunks"]) == 3
        aff = jbg.to_affine(jbg.pack([group.mul_scalar(group.g, k) for k in ks]))
        sums, bad = eng.window_sums_eager(aff, limbs, C_BITS, plans)
        out[f"g{arity}"], out[f"g{arity}_bad"] = conv(sums), np.array(bool(np.asarray(bad)))
    ks, scs = inputs["heavy"]
    jbg = jco.G1Batch(jax_fq())
    eng = mk(jbg, bn.g1)
    aff = jbg.to_affine(jbg.pack([bn.g1.mul_scalar(bn.g1.g, k) for k in ks]))
    limbs = jmsm.scalars_to_limbs(scs, C.R)
    for name, e in (("deg", eng), ("deg_complete", eng.fallback_engine())):
        sums, bad = e.window_sums_eager(aff, limbs, C_BITS)
        out[name], out[f"{name}_bad"] = conv(sums), np.array(bool(np.asarray(bad)))
    return out


@pytest.mark.slow
def test_chunk_record_is_live_jax_output():
    """The record is JAX's output today.  If this fails after a deliberate
    change to the JAX engine, rewrite the record with
    ``PYTHONPATH=. python tests/test_torch_chunked.py --write-record``."""
    live, rec = jax_record(), load_record()
    assert set(live) == set(rec)
    for k in live:
        np.testing.assert_array_equal(live[k], rec[k], err_msg=k)


if __name__ == "__main__":  # pragma: no cover - run by hand, needs JAX
    if "--write-record" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import conftest  # noqa: F401  (the CPU platform only)

        rec = jax_record()
        np.savez_compressed(CHUNK_RECORD, **rec)
        print("wrote", CHUNK_RECORD, {k: v.shape for k, v in rec.items()})
