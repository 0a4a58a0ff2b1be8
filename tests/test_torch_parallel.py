"""The port's multi-device prover (``go_snark_study_tpu_torch/parallel/``)
on the CPU, held against the JAX package's ``parallel/``.

Ranks are processes: ``parallel.launch.run_ranks`` spawns them over gloo on
the CPU and runs the rank programs of ``parallel/checks.py`` (a spawned
rank imports the module of its function, so they live in the package, not
here).  Two spawns serve the whole file, through module fixtures: four
ranks (meshes, the four-step NTT on the 1-D and the 2x2 mesh, the sharded
MSM and its card hook) and two ranks (the four-step NTT, the shape check,
one sharded proof).  The JAX side runs on the 8 virtual CPU devices that
``conftest.py`` provides.

The JAX sharded MSM (``ShardedMSMEngine._build``) compiles for about two
minutes on the CPU, so its window sums are a record: ``MSM_RECORD``
(``go_snark_study_tpu_torch/testdata/sharded_msm_window_sums.npz``) holds
JAX's sums for the inputs below, incomplete and complete, each coordinate
as (8, W) limbs in the port's layout, and the incomplete flag.  Rewrite it
with

    PYTHONPATH=. python tests/test_torch_parallel.py --write-record

and the ``slow`` test ``test_msm_record_is_live_jax_output`` holds it to a
live JAX run.
The sharded proof is compared with ``groth16_mul_chain30.npz``, the record
of JAX's ``FastGroth16`` that ``tests/test_torch_prover.py`` keeps.
"""

import json
import os
import random
import re
import sys

import numpy as np
import pytest
import torch

from go_snark_study_tpu_torch.bn128 import constants as C, default_bn128
from go_snark_study_tpu_torch.interop import jax_to_port, port_to_jax
from go_snark_study_tpu_torch.parallel import checks
from go_snark_study_tpu_torch.parallel.launch import call_all, run_ranks

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

N_NTT = 64  # n1 = n2 = 8: divisible by 2 and 4 ranks
MSM_POINTS, MSM_RANKS = 500, 4  # padded to 512: 128 lanes a rank, c = 8
HOOK_POINTS = 64
SHAPE_TIER = 14  # 8,194 signals a rank: at tile_threshold, so a chunked engine chunks them
GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "go_snark_study_tpu_torch", "testdata", "groth16_mul_chain30.npz",
)
N_CONSTRAINTS, CIRCUIT_SEED, RNG_SEED = 30, 1, 42

MSM_RECORD = os.path.join(os.path.dirname(GOLDEN), "sharded_msm_window_sums.npz")
COORDS = ("x", "y", "z")


def ntt_coeffs():
    rng = random.Random(1)
    return [rng.randrange(C.R) for _ in range(N_NTT)]


def msm_inputs():
    """(multipliers k, points k*G, scalars): distinct points, so the host
    oracle is one scalar multiplication, (sum k*s) * G."""
    bn = default_bn128()
    rng = random.Random(5)
    ks = [rng.randrange(1, 1 << 32) for _ in range(MSM_POINTS)]
    scs = [rng.randrange(C.R) for _ in range(MSM_POINTS)]
    return ks, [bn.g1.mul_scalar(bn.g1.g, k) for k in ks], scs


def oracle(ks, scs):
    bn = default_bn128()
    return bn.g1.mul_scalar(bn.g1.g, sum(k * s for k, s in zip(ks, scs)) % C.R)


def load_record() -> dict:
    with np.load(MSM_RECORD) as z:
        return {k: z[k] for k in z.files}


def assert_sums_equal(got, want, what: str):
    """Jacobian window sums, coordinate by coordinate, bit for bit: leaves
    (8, W) limbs, ``want`` stacked (3, 8, W)."""
    assert len(got) == len(want) == len(COORDS), (what, len(got), len(want))
    for coord, g, w in zip(COORDS, got, want):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=f"{what} window sums, coordinate {coord}")


def jax_msm_record() -> dict:
    """JAX's sharded window sums for ``msm_inputs`` on ``data_mesh(4)``,
    incomplete and complete: {name: (3, 8, W) limbs in the port's layout,
    name + "_bad": its flag}."""
    from go_snark_study_tpu.ops.curve_ops import G1Batch
    from go_snark_study_tpu.ops.fields import fq_kernels
    from go_snark_study_tpu.ops.msm import scalars_to_limbs
    from go_snark_study_tpu.parallel import data_mesh
    from go_snark_study_tpu.parallel.sharded_msm import ShardedMSMEngine

    bn = default_bn128()
    _, pts, scs = msm_inputs()
    eng = ShardedMSMEngine(G1Batch(fq_kernels()), bn.g1, C.R, data_mesh(MSM_RANKS))
    n = len(pts)
    quantum = eng.pad_quantum(max(1, n // MSM_RANKS)) * MSM_RANKS
    pad = (-n) % quantum
    dev_pts = eng.bg.pack(list(pts) + [bn.g1.zero()] * pad)
    limbs = scalars_to_limbs(list(scs) + [0] * pad, C.R)
    c = eng.window_bits_for((n + pad) // MSM_RANKS)
    out = {}
    for name, e in (("incomplete", eng), ("complete", eng.fallback_engine())):
        sums, bad = e._build(c)(dev_pts, limbs)
        out[name] = np.stack([jax_to_port(np.asarray(s)) for s in sums])
        out[name + "_bad"] = np.array(bool(np.asarray(bad)))
    return out


# ---------------------------------------------------------------------------
# fixtures: the JAX cases, the port setup, the two spawns
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_four_step():
    """JAX's FourStepNTT.forward of ``ntt_coeffs`` on data_mesh(2),
    data_mesh(4) and hier_mesh(2, 2), in the port's limb layout."""
    from go_snark_study_tpu.ops.ntt import NTTEngine
    from go_snark_study_tpu.parallel import data_mesh, hier_mesh
    from go_snark_study_tpu.parallel.sharded_ntt import FourStepNTT

    eng = NTTEngine()
    x = eng.K.pack(ntt_coeffs())
    meshes = {2: data_mesh(2), 4: data_mesh(4), (2, 2): hier_mesh(2, 2)}
    return {k: jax_to_port(np.asarray(FourStepNTT(m, eng).forward(x))) for k, m in meshes.items()}


@pytest.fixture(scope="module")
def four_ranks():
    ks, pts, scs = msm_inputs()
    return run_ranks(
        call_all, 4, "gloo", "cpu",
        (checks.mesh_report, ([4, (2, 2)], "cpu")),
        (checks.four_step, (ntt_coeffs(), [4, (2, 2)], "cpu")),
        (checks.msm_sums, (pts, scs, MSM_RANKS, "cpu")),
        (checks.msm_hook, (pts[:HOOK_POINTS], scs[:HOOK_POINTS], MSM_RANKS, "cpu")),
    )


@pytest.fixture(scope="module")
def port_setup():
    """One port setup of the golden circuit in this process, and the rng in
    its state after the setup (the record's prove draws r, s from it)."""
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    r1cs = mul_chain_r1cs(N_CONSTRAINTS, seed=CIRCUIT_SEED)
    rng = random.Random(RNG_SEED)
    setup = FastGroth16(device="cpu").setup(r1cs, rng=rng, materialize_host=True)
    return r1cs, setup, rng


@pytest.fixture(scope="module")
def two_ranks(port_setup):
    r1cs, setup, rng = port_setup
    return run_ranks(
        call_all, 2, "gloo", "cpu",
        (checks.four_step, (ntt_coeffs(), [2], "cpu")),
        (checks.shape_check, (SHAPE_TIER, 2, "cpu")),
        (checks.prove, (r1cs, setup.pk, rng, 2, "cpu")),
    )


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_data_mesh_of_four(four_ranks):
    for rank, (report, *_) in enumerate(four_ranks):
        m = report[4]
        assert (m["axis_names"], m["shape"], m["size"], m["rank"]) == (("data",), (4,), 4, rank)
        assert m["local"] == {"data": rank} and m["rank_sums"] == {"data": 0 + 1 + 2 + 3}


def test_hier_mesh_groups(four_ranks):
    """hier_mesh(2, 2): ranks (h, d) = divmod(rank, 2); the "data" group
    holds the ranks of one host, the "host" group one chip of each."""
    for rank, (report, *_) in enumerate(four_ranks):
        m = report[(2, 2)]
        host, chip = divmod(rank, 2)
        assert (m["axis_names"], m["shape"], m["size"]) == (("host", "data"), (2, 2), 4)
        assert m["local"] == {"host": host, "data": chip}
        assert m["rank_sums"] == {"data": 2 * host + 2 * host + 1, "host": chip + chip + 2}


def test_mesh_larger_than_world_raises_jax_text(four_ranks):
    """data_mesh(5), hier_mesh(3) and hier_mesh(2, 4) on four ranks raise
    the JAX package's ValueError text (its hint about virtual devices
    becomes one about ranks)."""
    import jax
    from go_snark_study_tpu.parallel import data_mesh, hier_mesh

    have = len(jax.devices())
    want = []
    for make in (lambda: data_mesh(have + 1), lambda: hier_mesh(have - 1), lambda: hier_mesh(2, have)):
        with pytest.raises(ValueError) as e:
            make()
        want.append(str(e.value))
    shape = lambda msg: re.sub(r"\d+", "N", msg.split(" (")[0])
    for report, *_ in four_ranks:
        got = report["errors"]
        assert [shape(g) for g in got] == [shape(w) for w in want]
        assert got[0].startswith("need 5 devices, have 4") and got[1] == "4 devices do not split into 3 hosts"
        assert got[2].startswith("need 8 devices, have 4")


# ---------------------------------------------------------------------------
# four-step NTT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", [2, 4, (2, 2)], ids=["data2", "data4", "host2xdata2"])
def test_four_step_matches_jax(layout, four_ranks, two_ranks, jax_four_step):
    """FourStepNTT.forward on every rank is JAX's, bit for bit, in the same
    permuted order; it is the single-device NTT permuted, and inverse
    undoes it."""
    runs = [r[0] for r in two_ranks] if layout == 2 else [r[1] for r in four_ranks]
    for ntt in runs:
        out = ntt[layout]
        np.testing.assert_array_equal(out["forward"], jax_four_step[layout])
        np.testing.assert_array_equal(port_to_jax(out["forward"]), port_to_jax(jax_four_step[layout]))
        assert out["matches_single"] and out["roundtrip"]


# ---------------------------------------------------------------------------
# sharded MSM
# ---------------------------------------------------------------------------
def test_sharded_window_sums_match_jax(four_ranks):
    """The mesh's Jacobian window sums on 4 ranks are JAX's
    ShardedMSMEngine._build(c) sums coordinate for coordinate, incomplete
    (its flag fired, so the complete re-run is taken) and complete."""
    rec = load_record()
    assert bool(rec["incomplete_bad"]) and not bool(rec["complete_bad"])
    for rank, (*_, sums, _hook) in enumerate(four_ranks):
        assert (sums["c"], sums["local"]) == (8, 128)
        assert sums["bad"] == bool(rec["incomplete_bad"])
        for name in ("incomplete", "complete"):
            assert_sums_equal(sums[name], rec[name], f"rank {rank} {name}")


def test_sharded_msm_matches_host(four_ranks):
    ks, _, scs = msm_inputs()
    want = oracle(ks, scs)
    bn = default_bn128()
    for *_, sums, _hook in four_ranks:
        assert bn.g1.equal(sums["total"], want)


def test_sharded_msm_hook_matches_host(four_ranks):
    """enable_gpu_msm(device="cpu", mesh=data_mesh(4), min_size=4): one
    64-point G1 MSM through ShardedMSMEngine.msm, its flag ORed over the
    ranks and re-run on every rank."""
    ks, _, scs = msm_inputs()
    want = oracle(ks[:HOOK_POINTS], scs[:HOOK_POINTS])
    bn = default_bn128()
    for *_, hook in four_ranks:
        assert bn.g1.equal(hook["total"], want)
        assert hook["fallback_hits"] == 1


# ---------------------------------------------------------------------------
# the sharded prover
# ---------------------------------------------------------------------------
def test_prove_sharded_is_golden_proof(port_setup, two_ranks):
    """prove_sharded on 2 ranks, from the port's setup and the rng in its
    state after setup, gives JAX's recorded proof as group elements on
    both ranks, and it verifies."""
    from go_snark_study_tpu_torch.models.groth16 import verify_proof

    r1cs, setup, _ = port_setup
    meta = json.loads(str(np.load(GOLDEN)["meta"]))["proof"]
    g1 = lambda p: tuple(int(c) for c in p)
    g2 = lambda p: tuple((int(c[0]), int(c[1])) for c in p)
    bn = default_bn128()
    proofs = [r[2] for r in two_ranks]
    for proof in proofs:
        assert bn.g1.equal(proof.pi_a, g1(meta["pi_a"]))
        assert bn.g2.equal(proof.pi_b, g2(meta["pi_b"]))
        assert bn.g1.equal(proof.pi_c, g1(meta["pi_c"]))
    assert proofs[0] == proofs[1]
    assert verify_proof(setup.vk, proofs[0], r1cs.witness[1 : r1cs.n_public + 1])


def test_dry_shape_check_matches_real_pipeline(two_ranks):
    """The dry rule that dry_shape_check runs, on a small chunked engine
    (4,096-lane chunks), is the layout the real sharded pipeline builds
    with that engine on each of 2 ranks for 2^14 + 3 signals: 3 chunks a
    shard at c = 13."""
    for r in two_ranks:
        dry, real = r[1]["dry"], r[1]["real"]
        assert dry["ok"] and dry["devices"] == 2 and dry["chunks_per_shard"] == 3
        assert {k: dry[k] for k in real} == real


def test_dry_shape_check_2pow22():
    """The 2^22 tier on a (2, 8) grid in the JAX package's accelerator
    configuration, the JAX function's values: 393,216 lanes a shard in 3
    chunks of 2^17, 13-bit windows."""
    from go_snark_study_tpu_torch.parallel.sharded_prover import dry_shape_check

    info = dry_shape_check(22, (2, 8))
    assert set(info) == {"tier", "mesh", "devices", "local_lanes", "chunks_per_shard", "window_bits",
                         "windows", "buckets_per_window", "plan_p_cap", "ok"}
    assert info["ok"] and info["devices"] == 16 and info["mesh"] == {"host": 2, "data": 8}
    assert (info["local_lanes"], info["chunks_per_shard"], info["window_bits"], info["windows"]) == (393216, 3, 13, 20)
    assert (info["buckets_per_window"], info["plan_p_cap"]) == (4160, 6272)


# ---------------------------------------------------------------------------
# slow: the entry points at JAX's shapes, scaling, the live JAX record
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_entry_at_jax_shapes():
    """entry() at 8,192 points (the tiled MSM path) and a 512-point domain."""
    from go_snark_study_tpu_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    sums, h = fn(*args)
    assert tuple(sums[0].shape) == (8, 26) and tuple(h.shape) == (8, 512)


@pytest.mark.slow
def test_dryrun_multichip_four_ranks():
    from go_snark_study_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(4, "gloo", device="cpu")


@pytest.mark.slow
def test_scaling_rows_are_correct():
    from go_snark_study_tpu_torch.parallel.scaling import run

    rows = run(per_dev=128, world_sizes=(1, 2, "2x2"), backend="gloo", device="cpu")
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert all(r["correct"] for r in rows)


@pytest.mark.slow
def test_msm_record_is_live_jax_output():
    """The record is JAX's output today.  If this fails after a deliberate
    change to the JAX engine, rewrite the record with
    ``PYTHONPATH=. python tests/test_torch_parallel.py --write-record``."""
    live, rec = jax_msm_record(), load_record()
    assert set(live) == set(rec)
    for name in ("incomplete", "complete"):
        assert bool(live[name + "_bad"]) == bool(rec[name + "_bad"]), name
        assert_sums_equal(list(live[name]), rec[name], f"live JAX {name}")


if __name__ == "__main__":  # pragma: no cover - run by hand, needs JAX
    if "--write-record" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import conftest  # noqa: F401  (8 virtual CPU devices, the CPU platform only)

        rec = jax_msm_record()
        np.savez_compressed(MSM_RECORD, **rec)
        print("wrote", MSM_RECORD, {k: v.shape for k, v in rec.items()})
