"""The port on the card: each CUDA kernel against its plain PyTorch version,
bit for bit (K1's MSM forms with their flags), a seeded setup and proof
against the JAX package's record, and a sharded proof over NCCL.

These tests need a CUDA device and skip without one.  They import neither
``jax`` nor the JAX package, so they run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import random

import pytest
import torch

from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.ops import mont_mul as mm
from go_snark_study_tpu_torch.ops import ntt_kernels as nk
from go_snark_study_tpu_torch.ops import point_add as pa
from go_snark_study_tpu_torch.ops.limbs import FieldKernels
from go_snark_study_tpu_torch.ops.ntt import NTTEngine

from test_torch_msm_scan import C_BITS, CASES, D_CHUNK, IDS, TILE, _leaves, _unleaves, make_inputs
from test_torch_prover import CIRCUIT_SEED, N_CONSTRAINTS, RNG_SEED, g1_from, g2_from, load_golden


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device):
    """Every kernel against its plain version, on the card, bit for bit."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)

    def rand(n, p):
        x = torch.randint(0, 2**32, (8, n), generator=gen, device=cuda_device, dtype=torch.int64)
        x[7] %= p >> 224
        return x.to(torch.int32)

    for p in (C.Q, C.R):
        a, b = rand(4096, p), rand(4096, p)
        assert torch.equal(mm.mont_mul(a, b, p), mm.mont_mul_plain(a, b, p))
    for arity in (1, 2):
        pt = lambda: tuple(rand(1000, C.Q) for _ in range(3)) if arity == 1 else \
            tuple((rand(1000, C.Q), rand(1000, C.Q)) for _ in range(3))
        p1, p2 = pt(), pt()
        for form in pa.FORMS:
            got, want = pa.point_add(form, arity, p1, p2), pa.point_add_plain(form, arity, p1, p2)
            if form.endswith("_f"):
                (got, gb), (want, wb) = got, want
                assert torch.equal(gb, wb)
            assert all(torch.equal(x, y) for x, y in zip(pa._leaves(got, arity), pa._leaves(want, arity)))
    ntt = NTTEngine(FieldKernels(C.R, cuda_device))
    for g in (2, 4, 8, 16):
        for lanes in (33, 300, 4097):  # ragged last blocks
            x = rand(g * lanes, C.R).reshape(8, g, lanes).contiguous()
            for inverse in (False, True):
                tw = ntt.small_table(g, inverse)
                assert torch.equal(nk.small_ntt(x, tw), nk.small_ntt_plain(x, tw)), (g, lanes, inverse)
    e, o, t = rand(777, C.R), rand(777, C.R), rand(777, C.R)
    assert all(torch.equal(x, y) for x, y in zip(nk.butterfly(e, o, t), nk.butterfly_plain(e, o, t)))
    for n in (2, 64, 4096, 8192):
        for rows in (1, 3):
            x = rand(n * rows, C.R)
            for inverse in (False, True):
                T = ntt.master(n, inverse)
                assert torch.equal(nk.radix2_ntt(x, T, n), nk.radix2_ntt_plain(x, T, n)), (n, rows, inverse)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_msm_forms_match_plain_on_card(cuda_device, case):
    """K1's MSM forms (apply, seg-scan, reduce) against their plain versions
    on the card, on the CPU tests' seeded inputs: equal limbs, equal flags,
    and the planted cases fire every flag."""
    from go_snark_study_tpu_torch.ops import msm
    from go_snark_study_tpu_torch.ops import msm_kernels as mk
    from go_snark_study_tpu_torch.ops.curve_ops import G1Batch

    arity, complete, planted = case
    pts, digits, seg, bk = make_inputs(arity, planted)
    dev = lambda p: _unleaves([torch.from_numpy(c).to(cuda_device) for c in _leaves(p, arity)], arity)
    eng = msm.MSMEngine(G1Batch(FieldKernels(C.Q, cuda_device)), None, C.R, window_bits=C_BITS,
                        tile_threshold=TILE, tile_lanes=TILE)
    plan = eng._plan_impl(torch.from_numpy(digits).to(cuda_device), C_BITS)
    for kernel, plain, args in (
        (mk.apply, mk.apply_plain, (dev(pts), plan)),
        (mk.seg_scan, mk.seg_scan_plain, (dev(seg), plan["comp_dig"])),
        (mk.reduce, mk.reduce_plain, (dev(bk), D_CHUNK)),
    ):
        (got, gbad), (want, wbad) = kernel(*args, arity, complete), plain(*args, arity, complete)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(_leaves(got, arity), _leaves(want, arity))), kernel
        assert bool(gbad) == bool(wbad), kernel
        if planted:
            assert bool(gbad), kernel


@pytest.mark.gpu
def test_multi_group_msm_on_card(cuda_device, monkeypatch):
    """A tiled MSM at 2^14 lanes whose 26 windows are split by a small
    group_bytes into 3 groups of 10, the last with 4 zero windows, in G1 and
    in G2 on the G1 plans: the kernels' window sums and flags equal the
    plain forms' (plain PyTorch on the card), and the combined results the
    host oracle (Σ k_i·s_i)·G."""
    from go_snark_study_tpu_torch.bn128 import default_bn128
    from go_snark_study_tpu_torch.ops import msm
    from go_snark_study_tpu_torch.ops import msm_kernels as mk
    from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, G2Batch, tree_leaves
    from go_snark_study_tpu_torch.ops.fixed_base import FixedBaseEngine

    bn = default_bn128()
    n = 1 << 14
    rng = random.Random(17)
    ks = [rng.randrange(1, C.R) for _ in range(n)]
    scs = [rng.randrange(C.R) for _ in range(n)]
    limbs = msm.scalars_to_limbs(scs, C.R, cuda_device)
    windows = msm.scalars_to_windows(ks, C.R, cuda_device)
    K = FieldKernels(C.Q, cuda_device)
    g1_bytes = 10 * n * 3 * 32 * 4  # 10 G1 windows a group
    plans = None
    for bg, group in ((G1Batch(K), bn.g1), (G2Batch(K), bn.g2)):
        aff = bg.to_affine(FixedBaseEngine(bg, group, group.g, C.R).batch_mul_device(windows))
        eng = msm.MSMEngine(bg, group, C.R, group_bytes=g1_bytes)
        c = eng.window_bits_for(n)
        if plans is None:
            plans = eng.make_plans(limbs, c)
            assert (plans["wg"], plans["wpad"], len(plans["plans"])) == (10, 4, 3)
        got, gbad = eng.window_sums_eager(aff, limbs, c, plans)
        with monkeypatch.context() as m:
            for name in ("apply", "seg_scan", "reduce"):
                m.setattr(mk, name, getattr(mk, name + "_plain"))
            want, wbad = eng.window_sums_eager(aff, limbs, c, plans)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(got), tree_leaves(want)))
        assert bool(gbad) == bool(wbad) is False
        total = msm.combine_window_sums(group, bg.unpack(got), c)
        expect = sum(k * s for k, s in zip(ks, scs)) % C.R
        assert group.equal(total, group.mul_scalar(group.g, expect))


@pytest.mark.gpu
def test_chunked_msm_on_card(cuda_device, monkeypatch):
    """A chunked MSM (8,192-lane chunks, c = 10) over 20,000 points, so 3
    chunks with 4,576 identity pad lanes: the kernels' window sums and flag
    equal the plain path's (the MSM forms and the cross-chunk per-lane add
    all plain PyTorch on the card), and the combined result the host oracle
    (Σ k_i·s_i)·G."""
    from go_snark_study_tpu_torch.bn128 import default_bn128
    from go_snark_study_tpu_torch.ops import msm
    from go_snark_study_tpu_torch.ops import msm_kernels as mk
    from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, tree_leaves
    from go_snark_study_tpu_torch.ops.fixed_base import FixedBaseEngine

    bn = default_bn128()
    n = 20000
    rng = random.Random(19)
    ks = [rng.randrange(1, C.R) for _ in range(n)]
    scs = [rng.randrange(C.R) for _ in range(n)]
    limbs = msm.scalars_to_limbs(scs, C.R, cuda_device)
    bg = G1Batch(FieldKernels(C.Q, cuda_device))
    aff = bg.to_affine(FixedBaseEngine(bg, bn.g1, bn.g1.g, C.R).batch_mul_device(msm.scalars_to_windows(ks, C.R,
                                                                                                       cuda_device)))
    eng = msm.MSMEngine(bg, bn.g1, C.R, window_bits=10, chunk_lanes=8192, small_chunk_lanes=0)
    assert eng.layout(n)["chunks"] == 3
    plans = eng.make_plans(limbs, 10)
    assert plans["mode"] == "chunk" and len(plans["chunks"]) == 3
    launches = pa.POINT_ADD.launches
    got, gbad = eng.window_sums_eager(aff, limbs, 10, plans)
    assert pa.POINT_ADD.launches - launches == 2  # the two cross-chunk adds
    with monkeypatch.context() as m:
        for name in ("apply", "seg_scan", "reduce"):
            m.setattr(mk, name, getattr(mk, name + "_plain"))
        m.setattr(pa, "point_add", pa.point_add_plain)
        want, wbad = eng.window_sums_eager(aff, limbs, 10, plans)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(got), tree_leaves(want)))
    assert bool(gbad) == bool(wbad) is False
    total = msm.combine_window_sums(bn.g1, bg.unpack(got), 10)
    assert bn.g1.equal(total, bn.g1.mul_scalar(bn.g1.g, sum(k * s for k, s in zip(ks, scs)) % C.R))


@pytest.mark.gpu
@pytest.mark.parametrize("arity", [1, 2], ids=["G1", "G2"])
def test_cross_chunk_add_on_card(cuda_device, arity):
    """K1's per-lane jadd_f on (8, W, M) bucket leaves, the cross-chunk add's
    shape at c = 13 (20 x 4,160), with identity lanes and planted equal
    lanes: equal to its plain version bit for bit, flags included."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(23 + arity)
    w, m = 20, 4160

    def rand():
        x = torch.randint(0, 2**32, (8, w, m), generator=gen, device=cuda_device, dtype=torch.int64)
        x[7] %= C.Q >> 224
        return x.to(torch.int32)

    pt = lambda: tuple(rand() for _ in range(3)) if arity == 1 else tuple((rand(), rand()) for _ in range(3))
    a, b = pt(), pt()
    lane = torch.arange(m, device=cuda_device).expand(w, m)
    same, ident = (lane % 97 == 5)[None], (lane % 89 == 7)[None]
    b = _unleaves([torch.where(same, x, y) for x, y in zip(_leaves(a, arity), _leaves(b, arity))], arity)
    b = _unleaves([torch.where(ident, 0, y).contiguous() for y in _leaves(b, arity)], arity)
    (got, gbad), (want, wbad) = pa.point_add("jadd_f", arity, a, b), pa.point_add_plain("jadd_f", arity, a, b)
    assert torch.equal(gbad, wbad) and bool(gbad.any()) and gbad.shape == (w, m)
    assert all(torch.equal(x, y) for x, y in zip(pa._leaves(got, arity), pa._leaves(want, arity)))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [C.Q, C.R], ids=["fq", "fr"])
def test_card_route_pack_is_python_route_on_card(cuda_device, p):
    """The host bridge's card route (bytes copied and relaid on the card,
    then K2 by R^2) against the Python Montgomery route at 2^16 lanes,
    bit for bit, Montgomery and plain; the edges 0, 1, p-1, p, -1 first."""
    from go_snark_study_tpu_torch import native
    from go_snark_study_tpu_torch.ops.msm import scalars_to_limbs

    rng = random.Random(11)
    xs = [0, 1, p - 1, p, -1] + [rng.randrange(p) for _ in range((1 << 16) - 5)]
    K = FieldKernels(p, cuda_device)
    for mont in (True, False):
        want = torch.from_numpy(K.pack_python(xs, mont)).to(cuda_device)
        assert torch.equal(K.pack(xs, mont), want), mont
        assert torch.equal(K.pack_bytes(native.ints_to_bytes(xs, p), mont), want), mont
    assert torch.equal(scalars_to_limbs(xs, p, cuda_device), torch.from_numpy(K.pack_python(xs, False)).to(cuda_device))


@pytest.mark.gpu
def test_card_proof_matches_jax_record(cuda_device):
    """Setup and prove on the card (device=None), with the seeds of the JAX
    record: the same vk and proof as JAX's FastGroth16, and it verifies."""
    from go_snark_study_tpu_torch.bn128 import default_bn128
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    meta, _ = load_golden()
    r1cs = mul_chain_r1cs(N_CONSTRAINTS, seed=CIRCUIT_SEED)
    rng = random.Random(RNG_SEED)
    fast = FastGroth16()
    assert fast.device.type == "cuda"
    setup = fast.setup(r1cs, rng=rng)
    proof = fast.prove(r1cs, setup.pk, rng=rng)

    bn = default_bn128()
    assert all(bn.g1.equal(got, g1_from(want)) for got, want in zip(setup.vk.ic, meta["vk"]["ic"]))
    want = meta["proof"]
    assert bn.g1.equal(proof.pi_a, g1_from(want["pi_a"]))
    assert bn.g2.equal(proof.pi_b, g2_from(want["pi_b"]))
    assert bn.g1.equal(proof.pi_c, g1_from(want["pi_c"]))
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    assert verify_proof(setup.vk, proof, publics)
    assert not verify_proof(setup.vk, proof, [publics[0] + 1])


@pytest.mark.gpu
def test_spans_in_events_mode_on_card(cuda_device, monkeypatch, tmp_path):
    """GOSNARK_MSM_PROFILE=events on a warm 2^12 proof on the card: no span
    synchronises, every span given the card has its device time from CUDA
    events, the phases nest under ``prove`` with one request id, each span
    is a user_annotation of the torch.profiler trace, and the proof
    verifies."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from go_snark_study_tpu_torch import profiling
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    r1cs = mul_chain_r1cs(1 << 12, seed=1)
    fast = FastGroth16()
    setup = fast.setup(r1cs, rng=random.Random(1), materialize_host=False)
    monkeypatch.delenv("GOSNARK_MSM_PROFILE", raising=False)
    fast.prove(r1cs, setup.pk, rng=random.Random(2))
    torch.cuda.synchronize()
    monkeypatch.setenv("GOSNARK_MSM_PROFILE", "events")
    monkeypatch.setattr(profiling, "PROFILER", profiling.Profiler())

    def no_sync(*a, **k):
        raise AssertionError("torch.cuda.synchronize in events mode")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", no_sync)
            proof = fast.prove(r1cs, setup.pk, rng=random.Random(3))
        torch.cuda.synchronize()
    ev = profiling.PROFILER.events()
    by = {e.label: e for e in ev}
    host_only = {"prove.row_evals", "prove.combine", "msm.combine", "prove.assemble"}
    assert {"prove", "prove.witness", "prove.h_inputs", "prove.h_inputs.products", "prove.plans", "prove.msm",
            "prove.h", "prove.h.ntt", "prove.h.msm", "prove.flags"} | host_only <= set(by)
    assert by["prove.h_inputs.products"].parent == by["prove.h_inputs"].span_id
    assert len({e.request for e in ev}) == 1 and by["prove"].parent is None and ev[-1] is by["prove"]
    assert by["prove.h.ntt"].parent == by["prove.h.msm"].parent == by["prove.h"].span_id
    assert all(e.parent == by["prove.combine"].span_id for e in ev if e.label == "msm.combine")
    for e in ev:
        if e.label in host_only:
            assert e.device_ms is None, e
        else:
            assert e.device_ms is not None and e.device_ms > 0, e
    assert by["prove"].device_ms >= by["prove.h.ntt"].device_ms + by["prove.h.msm"].device_ms
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    notes = sorted(e["name"] for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    assert notes == sorted(e.label for e in ev)
    assert verify_proof(setup.vk, proof, r1cs.witness[1 : r1cs.n_public + 1])


@pytest.mark.gpu
def test_staged_inputs_on_card(cuda_device):
    """Two 2^12 proofs back to back, with different witnesses, through the
    prover's pinned staging buffer (no fence between them): each verifies,
    each proof's four device inputs equal the bytes route's
    (``_row_evals_bytes`` -> ``bytes_to_limbs`` / ``pack_bytes``: the host
    products), every witness value took the C encoder, and both proofs'
    products took the SpMV kernel, one launch each."""
    from go_snark_study_tpu_torch import native
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.ops.limbs import bytes_to_limbs
    from go_snark_study_tpu_torch.ops.r1cs_spmv import SPMV
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    n = 1 << 12
    systems = [mul_chain_r1cs(n, seed=s) for s in (1, 2)]  # the same rows, two witnesses
    fast = FastGroth16()
    setup = fast.setup(systems[0], rng=random.Random(1), materialize_host=False)
    dpk = setup.pk._device
    seen = []
    prove_inputs = fast._prove_inputs

    def record(r1cs, d):
        before = dict(native.ENCODED)
        out = prove_inputs(r1cs, d)
        seen.append((out, {k: native.ENCODED[k] - before[k] for k in before}))
        return out

    fast._prove_inputs = record
    launches = SPMV.launches
    proofs = [fast.prove(r1cs, setup.pk, rng=random.Random(3 + i)) for i, r1cs in enumerate(systems)]
    torch.cuda.synchronize()
    assert SPMV.launches == launches + 2
    assert fast._stagings and all(st.buf.is_pinned() for st in fast._stagings.values())
    for r1cs, proof, ((w_limbs, wp_limbs, h_in), routes) in zip(systems, proofs, seen):
        assert verify_proof(setup.vk, proof, r1cs.witness[1 : r1cs.n_public + 1])
        a_b, b_b, c_b, w_b = r1cs._row_evals_bytes()
        want_w = bytes_to_limbs(w_b, cuda_device, dpk.m_pad)
        m, lo = len(r1cs.witness), dpk.lo
        assert torch.equal(w_limbs, want_w)
        assert torch.equal(wp_limbs[:, : m - lo], want_w[:, lo:m]) and not wp_limbs[:, m - lo :].any()
        assert all(torch.equal(x, fast.Kr.pack_bytes(v, lanes=dpk.n)) for x, v in zip(h_in, (a_b, b_b, c_b)))
        assert routes["python"] == 0 and routes["native"] == m, routes
    assert not torch.equal(seen[0][0][0], seen[1][0][0])


@pytest.mark.gpu
def test_spmv_matches_plain_on_card(cuda_device):
    """The SpMV kernel against its plain version on the CPU, bit for bit,
    over ``test_torch_spmv``'s systems (rows of one term to 200, every
    coefficient kind, a domain past the constraints), one launch each."""
    from go_snark_study_tpu_torch.models.groth16_fast import _next_pow2
    from go_snark_study_tpu_torch.ops import r1cs_spmv as sp
    from go_snark_study_tpu_torch.ops.limbs import bytes_to_rows
    from go_snark_study_tpu_torch.native import ints_to_bytes

    from test_torch_spmv import CASES, make_system

    for name in CASES:
        r1cs = make_system(name)
        n = _next_pow2(r1cs.n_constraints)
        w = bytes_to_rows(ints_to_bytes(r1cs.witness, C.R), "cpu")
        want = sp.r1cs_spmv_plain(sp.row_csr(r1cs, n, "cpu"), w)
        launches = sp.SPMV.launches
        got = sp.r1cs_spmv(sp.row_csr(r1cs, n, cuda_device), w.to(cuda_device))
        torch.cuda.synchronize()
        assert sp.SPMV.launches == launches + 1
        assert torch.equal(got.cpu(), want), name


@pytest.mark.gpu
def test_sharded_proof_nccl_one_rank_on_card(cuda_device):
    """prove_sharded over NCCL with one rank on the card, at 2^12
    constraints: the proof is FastGroth16.prove's from the same rng state,
    it verifies, and a wrong public input fails."""
    from go_snark_study_tpu_torch.parallel import checks
    from go_snark_study_tpu_torch.parallel.launch import run_ranks

    (out,) = run_ranks(checks.card_run, 1, "nccl", "cuda", 12, 1)
    assert out["device"].startswith("cuda")
    assert out["equal"] and out["verifies"] and out["wrong_public_fails"]


@pytest.mark.gpu
def test_transform_above_radix2_max_on_card(cuda_device):
    """Rows longer than K4's 2^13 through ``NTTEngine._transform`` on the card
    (four-step: K3 leaves, K2 twiddles), bit for bit with the plain radix-2
    stage loop."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    ntt = NTTEngine(FieldKernels(C.R, cuda_device))
    for rows, n in ((2, 1 << 14), (1, 1 << 15)):
        x = torch.randint(0, 2**32, (8, rows * n), generator=gen, device=cuda_device, dtype=torch.int64)
        x[7] %= C.R >> 224
        x = x.to(torch.int32)
        for inverse in (False, True):
            T = ntt.master(n, inverse)
            assert torch.equal(ntt._transform(x, T, n), nk.radix2_ntt_plain(x, T, n)), (rows, n, inverse)


@pytest.mark.gpu
@pytest.mark.parametrize("protocol", ["groth16", "pinocchio"])
def test_accelerated_flows_on_card(cuda_device, protocol):
    """The parity protocols with the card hooks on (device=None) on the cubic
    circuit: they verify, and every key and proof point equals the host
    loops' as a group element."""
    from go_snark_study_tpu_torch import api
    from go_snark_study_tpu_torch.models import groth16, pinocchio

    from test_torch_accel import CUBIC, hooked_and_host, same_points

    flow, mod = {"groth16": (api.groth16_flow, groth16), "pinocchio": (api.pinocchio_flow, pinocchio)}[protocol]
    bundle = api.compile_circuit(source=CUBIC, private_inputs=[3], public_inputs=[35])
    (setup, proof, ok), (hsetup, hproof, hok) = hooked_and_host(flow, bundle, 21, None)
    assert ok and hok
    assert same_points(setup, hsetup) > 20
    assert same_points(proof, hproof) >= 3
    assert not mod.verify_proof(setup.vk, proof, [36])


@pytest.mark.gpu
def test_cli_fast_flow_on_card(cuda_device, tmp_path, monkeypatch):
    """The --fast CLI flow on the card (``main(argv)``, device=None) on a
    30-link chain: compile, setup into the key file, prove, verify, and a
    tampered public input that fails; with GOSNARK_MSM_PROFILE=1 a prove
    records its phases."""
    import json

    from chip_smoke import chain_source
    from go_snark_study_tpu_torch import profiling
    from go_snark_study_tpu_torch.cli import main

    src, priv, pub = chain_source(30)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "chain.circuit").write_text(src)
    (tmp_path / "privateInputs.json").write_text(json.dumps([str(x) for x in priv]))
    (tmp_path / "publicInputs.json").write_text(json.dumps([str(x) for x in pub]))
    assert main(["compile", "chain.circuit", "--fast"]) == 0
    assert main(["groth16", "trustedsetup", "--fast"]) == 0
    monkeypatch.setenv("GOSNARK_MSM_PROFILE", "1")
    profiling.PROFILER.reset()
    assert main(["groth16", "genproofs", "--fast"]) == 0
    assert {"prove", "prove.msm", "prove.h"} <= set(profiling.PROFILER.times)
    assert main(["groth16", "verify"]) == 0
    (tmp_path / "publicInputs.json").write_text(json.dumps([str(pub[0] + 1)]))
    assert main(["groth16", "verify"]) == 1


@pytest.mark.gpu
def test_keyfile_roundtrip_on_card(cuda_device, tmp_path):
    """A setup on the card without host lists, saved and loaded back onto
    the card: every tensor equal, and a proof from the loaded key
    verifies."""
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs
    from go_snark_study_tpu_torch.utils import keyfile

    from chip_smoke import device_pk_leaves

    r1cs = mul_chain_r1cs(N_CONSTRAINTS, seed=CIRCUIT_SEED)
    fast = FastGroth16()
    setup = fast.setup(r1cs, rng=random.Random(RNG_SEED), materialize_host=False)
    assert setup.pk.g1.at == []
    path = str(tmp_path / keyfile.KEYFILE)
    keyfile.save_fast_setup(path, setup.strip_toxic())
    loaded = keyfile.load_fast_setup(path)
    got, want = device_pk_leaves(loaded.pk._device), device_pk_leaves(setup.pk._device)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert got[name].is_cuda and torch.equal(got[name], t), name
    proof = fast.prove(r1cs, loaded.pk, rng=random.Random(1))
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    assert verify_proof(loaded.vk, proof, publics)


@pytest.mark.gpu
def test_bench_module_on_card(cuda_device):
    """``python -m go_snark_study_tpu_torch.bench`` as a user runs it, at
    small sizes through bench.py's variables: exit 0 and bench.py's line
    last, every result right, no failed stage, each share at most 1."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, GOSNARK_BENCH_MSM="16384", GOSNARK_BENCH_NTT="16384", GOSNARK_BENCH_PROVE="14",
               GOSNARK_BENCH_MSM21="0", PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-m", "go_snark_study_tpu_torch.bench"], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    sub = line["sub"]
    assert line["metric"] == "msm_g1_points_per_sec_2^14" and line["correct"] is True and line["value"] > 0
    assert not [k for k in sub if k.startswith(("error_", "skipped_"))], sub
    assert set(sub["mfu"]) == {"msm_accumulate", "ntt_butterfly", "modmul"}
    assert all(0 < v <= 1 for v in sub["mfu"].values()), sub["mfu"]
    assert {"groth16_setup_2^14_s", "groth16_prove_2^14_s", "groth16_prove_cold_2^14_s", "pk_hbm_2^14_mb"} <= set(sub)
    assert sub["card"] not in ("", "cpu") and sub["chip_model"] == "NVIDIA H100 SXM"
    assert sub["launches"]["K1 apply"] > 0 and sub["launches"]["K3"] > 0
