"""The port's remaining host surfaces against the JAX package's: the
embeddable API (``embed.py``), its HTTP server (``server.py``, with its own
``webclient/snark.js``), the circom/snarkjs verifier (``externalverif/``),
the float QAP twin (``r1csqap/float_qap.py``), the profiler and its cost
model (``profiling.py``), and ``FastGroth16.warmup`` on the CPU."""

import json
import os
import random
import threading
import urllib.error
import urllib.request

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def artifacts():
    """Cubic circuit, Pinocchio and Groth16 setups and a Groth16 proof, in
    the decimal *String dialect the embed API takes."""
    from go_snark_study_tpu_torch.api import compile_circuit
    from go_snark_study_tpu_torch.models import groth16, pinocchio
    from go_snark_study_tpu_torch.utils import base10

    src = open(os.path.join(REPO, "circuitexamples", "test.circuit")).read()
    b = compile_circuit(source=src, private_inputs=[3], public_inputs=[35])
    rng = random.Random(5)
    args = (len(b.witness), b.circuit, b.alphas, b.betas, b.gammas)
    psetup = pinocchio.generate_trusted_setup(*args, rng=rng).strip_toxic()
    gsetup = groth16.generate_trusted_setup(*args, rng=rng).strip_toxic()
    gproof = groth16.generate_proofs(b.circuit, gsetup.pk, b.witness, b.px, rng=rng)
    return dict(
        circuit=base10.circuit_to_dict(b.circuit),
        setup=base10.setup_to_dict(psetup),
        groth_setup=base10.groth_setup_to_dict(gsetup),
        px=base10.arr(b.px),
        gsetup=gsetup,
        gproof=gproof,
    )


def test_embed_pinocchio_roundtrip(artifacts):
    from go_snark_study_tpu_torch import embed

    a = artifacts
    setup_json = json.dumps(a["setup"])
    proof_json = embed.generate_proofs(json.dumps(a["circuit"]), setup_json, json.dumps(a["px"]), "[3]")
    assert set(json.loads(proof_json)) == {"PiA", "PiAp", "PiB", "PiBp", "PiC", "PiCp", "PiH", "PiKp"}
    assert json.loads(embed.verify_proofs(proof_json, setup_json, "[35]")) == {"verified": True}


def test_embed_groth16_roundtrip(artifacts):
    from go_snark_study_tpu_torch import embed

    a = artifacts
    setup_json = json.dumps(a["groth_setup"])
    proof_json = embed.groth_generate_proofs(json.dumps(a["circuit"]), setup_json, json.dumps(a["px"]), "[3]")
    assert set(json.loads(proof_json)) == {"PiA", "PiB", "PiC"}
    assert json.loads(embed.groth_verify_proofs(proof_json, setup_json, "[35]")) == {"verified": True}
    assert json.loads(embed.groth_verify_proofs(proof_json, setup_json, "[34]")) == {"verified": False}


def test_server_endpoints_and_snark_js(artifacts):
    """The four POST endpoints and ``/snark.js`` (the port's own copy, the
    same code as the JAX package's) on an ephemeral port."""
    from go_snark_study_tpu_torch import server

    a = artifacts
    srv = server.make_server(0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def post(path, obj):
        req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    try:
        gen = {"circuit": a["circuit"], "px": a["px"], "inputs": ["3"]}
        proof = post("/generateProofs", dict(gen, setup=a["setup"]))
        assert "PiH" in proof
        assert post("/verifyProofs", {"proof": proof, "setup": a["setup"], "publicInputs": ["35"]}) == \
            {"verified": True}
        gproof = post("/grothGenerateProofs", dict(gen, setup=a["groth_setup"]))
        assert set(gproof) == {"PiA", "PiB", "PiC"}
        assert post("/grothVerifyProofs", {"proof": gproof, "setup": a["groth_setup"], "publicInputs": ["36"]}) == \
            {"verified": False}
        with urllib.request.urlopen(base + "/snark.js", timeout=30) as resp:
            js = resp.read().decode()
        for fn in ("generateProofs", "verifyProofs", "grothGenerateProofs", "grothVerifyProofs"):
            assert f"function {fn}(" in js
        with urllib.request.urlopen(base + "/", timeout=30) as resp:
            assert "demo-vectors.json" in resp.read().decode()
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/nowhere", {})
        assert err.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
    jax_js = open(os.path.join(REPO, "go_snark_study_tpu", "webclient", "snark.js")).read()
    body = lambda text: text[text.index('"use strict";'):]  # the code, below the header comment
    assert body(js) == body(jax_js)


def _circom(vk, proof):
    """Groth16 vk and proof -> snarkjs' verification_key.json / proof.json
    dicts (decimal strings)."""
    s = lambda p: [str(c) for c in p]
    s2 = lambda p: [[str(c[0]), str(c[1])] for c in p]
    return ({"IC": [s(p) for p in vk.ic], "vk_alfa_1": s(vk.g1.alpha), "vk_beta_2": s2(vk.g2.beta),
             "vk_gamma_2": s2(vk.g2.gamma), "vk_delta_2": s2(vk.g2.delta)},
            {"pi_a": s(proof.pi_a), "pi_b": s2(proof.pi_b), "pi_c": s(proof.pi_c)})


def test_circom_verifier_on_snarkjs_shaped_files(artifacts, tmp_path):
    from go_snark_study_tpu_torch.externalverif import verify_from_circom

    vk, proof = _circom(artifacts["gsetup"].vk, artifacts["gproof"])
    for name, obj in (("verification_key.json", vk), ("proof.json", proof), ("public.json", ["35"]),
                      ("wrong.json", ["36"])):
        (tmp_path / name).write_text(json.dumps(obj))
    paths = [str(tmp_path / n) for n in ("verification_key.json", "proof.json")]
    assert verify_from_circom(*paths, str(tmp_path / "public.json"))
    assert not verify_from_circom(*paths, str(tmp_path / "wrong.json"))


def _circom_dir():
    from test_serialization import CIRCOM_DIR

    return CIRCOM_DIR


@pytest.mark.skipif(not os.path.isdir(_circom_dir()), reason="reference circom fixtures not mounted")
def test_circom_snarkjs_golden_verification():
    from go_snark_study_tpu_torch.externalverif import verify_from_circom

    d = _circom_dir()
    assert verify_from_circom(*(os.path.join(d, f) for f in ("verification_key.json", "proof.json", "public.json")))


def test_float_qap_matches_jax():
    from go_snark_study_tpu.r1csqap import float_qap as jax_fq
    from go_snark_study_tpu_torch.r1csqap import float_qap as fq

    # the Vitalik cubic's R1CS (r1csqapFloat_test.go)
    a = [[0, 1, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0], [0, 1, 0, 0, 1, 0], [5, 0, 0, 0, 0, 1]]
    b = [[0, 1, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0]]
    c = [[0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 1], [0, 0, 1, 0, 0, 0]]
    got = fq.r1cs_to_qap(a, b, c)
    assert got == jax_fq.r1cs_to_qap(a, b, c)
    assert got[3] == [24.0, -50.0, 35.0, -10.0, 1.0]
    w = [1, 3, 35, 9, 27, 30]
    ax, bx, cx, px = fq.combine_polynomials(w, *got[:3])
    assert (ax, bx, cx, px) == jax_fq.combine_polynomials(w, *got[:3])
    assert fq.divisor_polynomial(px, got[3]) == jax_fq.divisor_polynomial(px, got[3])


def test_kernel_cost_and_h100_bound():
    """K2 at 65,536 lanes is bytes-bound at 0.00188 ms on the H100 model
    (PERF.md), and chip_smoke.py's bound reads the same model: its numbers
    equal those of the formula it printed before, at the card's clock."""
    import chip_smoke
    from go_snark_study_tpu_torch import profiling

    h100 = profiling.CHIP_MODELS["h100"]
    cost = profiling.kernel_cost("mont_mul", 65536)
    s, by = h100.bound_s(cost["bytes"], cost["int32_ops"])
    assert by == "bytes" and round(s * 1e3, 5) == 0.00188
    assert cost["int32_ops"] == 264 * 65536 and cost["bytes"] == 96 * 65536
    clock = 1980e6

    def before(nbytes, imads):  # the formula chip_smoke.py used before it read profiling.py
        t_bytes, t_ops = nbytes / 3.35e12, imads / (132 * 64 * clock)
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    cases = [("mont_mul", 65536, 1, 16), ("point_add", 67584, 1, 16), ("point_add", 67584, 2, 16),
             ("small_ntt", 4096, 1, 16), ("small_ntt", 262144, 1, 4), ("radix2_ntt", 4096, 1, 16)]
    products = {"mont_mul": 1, ("point_add", 1): 16, ("point_add", 2): 43, ("small_ntt", 16): 17,
                ("small_ntt", 4): 1}
    for kind, n, group, g in cases:
        c = profiling.kernel_cost(kind, n, group=group, g=g)
        assert chip_smoke.bound_ms(c["bytes"], c["int32_ops"], clock) == before(c["bytes"], c["int32_ops"])
        want = {"mont_mul": n, "point_add": products.get((kind, group), 0) * n,
                "small_ntt": products.get((kind, g), 0) * n,
                "radix2_ntt": sum(n // 2 - n // (1 << s) for s in range(1, n.bit_length()))}[kind]
        assert c["products"] == want, (kind, n, group, g)
    assert chip_smoke.bound_ms(96 * 65536, 264 * 65536, clock) == before(96 * 65536, 264 * 65536)


def test_profiler_records_and_reports(monkeypatch):
    """A span records nothing with the variable unset, and its label, call
    count and time with it set to 1; ``record`` adds to the totals."""
    from go_snark_study_tpu_torch import profiling

    prof = profiling.Profiler()
    prof.record("step", 1e-3)
    prof.record("step", 2e-3)
    assert prof.calls["step"] == 2 and prof.times["step"] == pytest.approx(3e-3)
    monkeypatch.delenv("GOSNARK_MSM_PROFILE", raising=False)
    before = dict(profiling.PROFILER.calls)
    with profiling.span("test.span"):
        pass
    assert dict(profiling.PROFILER.calls) == before
    monkeypatch.setenv("GOSNARK_MSM_PROFILE", "1")
    with profiling.span("test.span", "cpu"):
        pass
    assert profiling.PROFILER.calls["test.span"] == 1


@pytest.mark.parametrize("earlier", [None, "1", "0"])
def test_profiling_block_restores_the_variable(monkeypatch, earlier):
    """profiling() records spans inside its block with a fresh profiler and
    leaves GOSNARK_MSM_PROFILE as it found it, set or not."""
    from go_snark_study_tpu_torch import profiling

    if earlier is None:
        monkeypatch.delenv("GOSNARK_MSM_PROFILE", raising=False)
    else:
        monkeypatch.setenv("GOSNARK_MSM_PROFILE", earlier)
    profiling.PROFILER.record("test.stale", 1.0)
    with profiling.profiling() as prof:
        assert prof is profiling.PROFILER and "test.stale" not in prof.calls
        with profiling.span("test.block", "cpu"):
            pass
    assert prof.calls["test.block"] == 1
    assert os.environ.get("GOSNARK_MSM_PROFILE") == earlier


def test_launch_count_registry():
    """profiling.kernel_objects names every kernel of the port once, with
    its source and the TPU kernel it replaces (the SpMV replaces none: the
    host products it took over); reset_counts zeroes every
    count (K1's per-instance ones too) and launch_counts reads them.  A CPU
    tensor takes the plain version, which counts nothing."""
    from go_snark_study_tpu_torch import profiling
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import mont_mul as mm, point_add as pa

    objs = profiling.kernel_objects()
    assert list(objs) == ["K1", "K1 apply", "K1 seg-scan", "K1 reduce", "K2", "K3", "K4", "K4 stage", "SpMV"]
    assert len({id(k) for k in objs.values()}) == len(objs)
    for name, k in objs.items():
        assert os.path.exists(os.path.join(REPO, k.source_path))
        pallas = "go_snark_study_tpu/ops/pallas_"
        assert k.replaces.startswith("none: native/" if name == "SpMV" else pallas), k.replaces
    objs["K2"].launches = 3
    pa.INSTANCE_LAUNCHES[("jadd", 1)] = 2
    assert profiling.launch_counts()["K2"] == 3
    profiling.reset_counts()
    assert set(profiling.launch_counts().values()) == {0} and set(pa.INSTANCE_LAUNCHES.values()) == {0}
    a = torch.zeros(8, 4, dtype=torch.int32)
    mm.mont_mul(a, a, C.R)
    assert set(profiling.launch_counts().values()) == {0}


def test_warmup_on_the_cpu_is_idempotent():
    """On the CPU there is nothing to build; the H pipeline of a domain runs
    once on zeros, and a second call finds its tables cached."""
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

    fast = FastGroth16(device="cpu")
    first = fast.warmup(families=(), domains=(16,))
    assert set(first) == {"h[2^4]"}
    tables = dict(fast.ntt._cache)
    second = fast.warmup(families=(), domains=(16,))
    assert set(second) == {"h[2^4]"} and fast.ntt._cache.keys() == tables.keys()
