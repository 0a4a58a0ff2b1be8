"""The harness on the CPU: cells resolve by name, a cell added as files is
run, the generator and the readers count right, nothing imports JAX, and
BENCHMARK.json keeps to its format.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, spec, tracing
from benchmark.tests import cells
from benchmark.traffic import R, Traffic

BENCH = spec.load_json(spec.REPO_ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return cells.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert callable(cell.system) and cell.traffic["loop"] == "closed"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer and set(cell.readers) == {m["name"] for m in cell.end_to_end + cell.per_layer}


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_a_cell_added_as_files_runs(tiny_root):
    cell = cells.load(tiny_root, "tiny-msm")
    line, checks = harness.run_cell(cell, cells.SEED, 0.5, False, time.perf_counter(), device="cpu")
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"msm_points_per_s", "setup_s"}
    assert list(line)[-1] == "checks" and line["checks"]["wrong_answers"] == {"value": 0, "limit": 0,
                                                                               "compared": line["attempted"]}
    assert checks[0].startswith("check wrong_answers: 0")


def test_a_metric_that_reads_nothing_fails_the_run(tiny_root):
    cell = cells.load(tiny_root, "tiny-msm")
    cell.readers["msm_points_per_s"] = lambda run: None
    with pytest.raises(harness.NotMeasured, match="msm_points_per_s"):
        harness.run_cell(cell, cells.SEED, 0.1, False, time.perf_counter(), device="cpu")


def test_no_card_means_no_result(tiny_root, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.SetupError):
        harness.run_cell(cells.load(tiny_root, "tiny-msm"), 1, 0.5, False, time.perf_counter())


def test_no_native_library_means_no_result(tiny_root, monkeypatch):
    from go_snark_study_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(harness.SetupError):
        harness.run_cell(cells.load(tiny_root, "tiny-msm"), 1, 0.5, False, time.perf_counter(), device="cpu")


def test_run_without_a_card_prints_nothing(tmp_path):
    """The command itself, in a directory that holds only BENCHMARK.json and
    benchmark/: exit 2 and no result line."""
    cells.make_root(tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "msm-2e20", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


# -- the generator -----------------------------------------------------------
def test_uniform_pool_counts():
    t = Traffic(spec.load_json(spec.PACKAGE_DIR / "traffic" / "closed-uniform4.json"), 2**31 + 5)
    pool = t.scalar_pool(1000, "cpu")
    assert pool.limbs.shape == (4, 8, 1000) and pool.limbs.dtype == torch.int32
    u = pool.limbs.numpy().view(np.uint32)
    assert int(u[:, 7].max()) < (R >> 224) and not np.array_equal(u[0], u[1])
    assert pool[2].data_ptr() == pool.limbs[2].data_ptr()  # full limbs: the vector itself, no copy
    again = Traffic(t.params, 2**31 + 5).scalar_pool(1000, "cpu")
    assert torch.equal(pool.limbs, again.limbs)


def test_num2bits_pool_counts():
    params = spec.load_json(spec.PACKAGE_DIR / "traffic" / "closed-num2bits1024.json")
    t = Traffic(dict(params, pool=70), 2**31 + 7)  # more than one block of 64
    pool = t.scalar_pool(33 * 40, "cpu")
    assert pool.limbs.shape == (70, 1, 33 * 40) and pool.size == 70
    lanes = pool.limbs[:, 0].numpy().view(np.uint32).reshape(70, 40, 33)
    assert set(np.unique(lanes[:, :, :32])) == {0, 1}
    assert (lanes[:, :, 32] > 1).mean() > 0.99 and lanes[:, :, 32].max() >= 1 << 31  # words span 32 bits
    x = pool[69]
    assert x.shape == (8, 33 * 40) and not x[1:].any() and torch.equal(x[0], pool.limbs[69, 0])
    assert torch.equal(pool[3][0], pool.limbs[3, 0])  # the buffer takes each vector in turn
    again = Traffic(t.params, 2**31 + 7).scalar_pool(33 * 40, "cpu")
    assert torch.equal(pool.limbs, again.limbs)
    other = Traffic(t.params, 2**31 + 8).scalar_pool(33 * 40, "cpu")  # another seed: other values
    assert not torch.equal(pool.limbs, other.limbs)
    assert len({v.tobytes() for v in lanes}) == 70


def test_reference_sums_are_exact():
    """The float64 limb products give the integers' sums exactly, the
    control's cleared bit included."""
    from benchmark import reference

    g = torch.Generator().manual_seed(5)
    n = 4096
    ks = torch.randint(-(1 << 31), 1 << 31, (8, n), generator=g, dtype=torch.int32)
    ks[:, :8] = -1  # limbs of all ones: the largest halves
    sc = torch.randint(-(1 << 31), 1 << 31, (3, 8, n), generator=g, dtype=torch.int32)
    sc[0, :, :8] = -1
    ints = lambda x: [int.from_bytes(x[:, i].numpy().astype(np.uint32).tobytes(), "little") for i in range(n)]
    kv = ints(ks)
    for b in (0, 254, 32):
        want = [sum((s & ~(1 << (b - 1)) if b else s) * k for s, k in zip(ints(sc[v]), kv)) for v in range(3)]
        assert reference.limb_dots(sc, ks, b - 1 if b else -1) == want
    low = [[int(v) for v in sc[j, 0].numpy().view(np.uint32)] for j in range(3)]  # only the low limb given
    assert reference.limb_dots(sc[:, :1], ks) == [sum(s * k for s, k in zip(low[j], kv)) for j in range(3)]


def test_witness_pool_and_sample():
    t = Traffic(spec.load_json(spec.PACKAGE_DIR / "traffic" / "closed-witness4.json"), 11)
    seeds = t.chain_seeds()
    assert len(seeds) == 4 and len(set(seeds)) == 4 and all(2 <= s < R for p in seeds for s in p)
    w = t.chain_witness(8, *seeds[0])
    assert len(w) == 11 and w[0] == 1 and w[1] == w[-1] and w[4] == w[3] * w[2] % R
    assert t.sample(10) == list(range(10))
    s = t.sample(1000)
    assert len(s) == 64 and s[0] == 0 and s[-1] == 999 and s == sorted(set(s))
    assert [t.input_index(i) for i in range(6)] == [0, 1, 2, 3, 0, 1]


# -- the readers ------------------------------------------------------------
def _run_with(**kw):
    cell = spec.load_cell("prove-2e20")
    run = harness.Run(cell=cell)
    for k, v in kw.items():
        setattr(run, k, v)
    return cell, run


def test_end_to_end_readers_count():
    cell, run = _run_with(window=(0.0, 10.0), requests=[(i * 0.1, i * 0.1 + 0.1 + (0.05 if i == 99 else 0))
                                                         for i in range(100)], setup_s=12.5)
    r = cell.readers
    assert r["prove_s"](run) == pytest.approx(0.1)
    p95 = spec.load_cell("prove-2e16").readers["prove_p95_s"]
    assert p95(run) == pytest.approx(0.1)  # the 95th of 100: one slow proof is beyond it
    assert r["setup_s"](run) == 12.5
    m = spec.load_cell("msm-2e20")
    run.points_per_request = 1 << 20
    assert m.readers["msm_points_per_s"](run) == pytest.approx(100 * (1 << 20) / 10.0)


def test_span_and_gc_readers_count():
    cell, run = _run_with(requests=[(0, 1)] * 4, spans={"prove.row_evals": [0.4, 4], "prove.witness": [0.02, 4],
                                                         "prove.combine": [0.08, 4]},
                          gc_pauses=[(0.5, 0.003, 0), (0.7, 0.001, 1)], setup={"trusted_setup_s": 10.5})
    r = cell.readers
    assert r["bridge_ms.prove"](run) == pytest.approx(105.0)
    assert r["assembly_ms.prove"](run) == pytest.approx(20.0)
    assert r["gc_pause_ms.prove"](run) == pytest.approx(1.0)
    assert r["trusted_setup_s"](run) == 10.5
    run.spans = {}
    assert r["bridge_ms.prove"](run) is None
    m = spec.load_cell("msm-2e20-bits")
    run.reruns = 1
    assert m.readers["rerun_share.msm"](run) == pytest.approx(25.0)


def _trace(ops, counted, requests=2, span=(1000.0, 2000.0)):
    t = tracing.DeviceTrace()
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.MARK, "ts": span[0], "dur": span[1] - span[0]}]
    events += [{"ph": "X", "cat": c, "name": n, "ts": a, "dur": d} for n, c, a, d in ops]
    t._read(events)
    t.host0, t.requests = 5.0, requests
    t.counters_before, t.counters_after = {"K1 apply": 10}, {"K1 apply": 10 + counted}
    return t


def test_device_readers_count():
    ops = [("msm_apply_kernel<1>", "kernel", 1100.0, 200.0), ("msm_apply_kernel<1>", "kernel", 1250.0, 100.0),
           ("elementwise_kernel", "kernel", 1500.0, 100.0), ("Memcpy HtoD", "gpu_memcpy", 1900.0, 200.0),
           ("early", "kernel", 900.0, 50.0)]
    cell, run = _run_with(trace=_trace(ops, counted=2), card={"sm_clock_hz": 1.98e9},
                          msm_works=[{"int32_ops": 1.98e9 * 8448 * 50e-6, "bytes": 0}])
    r = cell.readers
    assert run.trace.busy_s() == pytest.approx(450e-6)  # 1100-1350, 1500-1600, 1900-2000
    assert r["device_idle.prove"](run) == pytest.approx(55.0)
    assert r["k1_device_ms.prove"](run) == pytest.approx(0.15)  # 300 us over 2 requests
    assert r["launches.prove"](run) == pytest.approx(1.5)  # 3 kernels in the block, over 2 requests
    assert r["msm_roofline.prove"](run) == pytest.approx(100 * 50 / 300)
    assert run.trace.top_ops(2) == [["msm_apply_kernel<1>", pytest.approx(300e-6)],
                                    ["Memcpy HtoD", pytest.approx(200e-6)]]
    tail, msm = spec.load_cell("prove-2e16").readers, spec.load_cell("msm-2e20").readers  # one reader for each kind
    for name in ("k1_device_ms", "msm_roofline", "device_idle", "launches"):
        assert tail[f"{name}.prove_p95"](run) == r[f"{name}.prove"](run)
    assert msm["k1_device_ms.msm"](run) == r["k1_device_ms.prove"](run)
    gaps = run.trace.idle_gaps([("prove.row_evals", 5.0, 5.0001)], [(5.00041, 0.0001, 0)])
    assert gaps == [["outside spans", pytest.approx(300e-6)], ["gc.generation0", pytest.approx(150e-6)],
                    ["prove.row_evals", pytest.approx(100e-6)]]
    run.trace = _trace(ops, counted=3)  # the profiler dropped a K1 event: no K1 reading
    assert r["k1_device_ms.prove"](run) is None and r["msm_roofline.prove"](run) is None


# -- imports ----------------------------------------------------------------
def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    files = [p for p in spec.PACKAGE_DIR.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        for mod in _imports(p):
            assert mod.split(".")[0] not in harness.FORBIDDEN_TOP_LEVEL, (p, mod)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "cost.py", "traffic.py"):
        for mod in _imports(spec.PACKAGE_DIR / name):
            assert not mod.split(".")[0].startswith("go_snark_study_tpu"), (name, mod)
    code = ("import sys, benchmark.reference as r; r.g2_mul(5); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO_ROOT, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not {m for m in loaded if m.startswith("go_snark_study_tpu") or m in harness.FORBIDDEN_TOP_LEVEL}


def test_a_run_loads_no_jax(tiny_root):
    """What a whole run loads, in its own process, by top-level names
    compared whole (the port's name begins with the JAX package's)."""
    code = ("import sys, time; from pathlib import Path; from benchmark import harness; "
            "from benchmark.tests import cells; root = Path(sys.argv[1]); "
            "line, _ = harness.run_cell(cells.load(root, 'tiny-bits'), 5, 0.2, False, time.perf_counter(), "
            "device='cpu'); assert line['correct']; print(harness.forbidden_modules(), "
            "'go_snark_study_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(tiny_root)], cwd=spec.REPO_ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]", "True"]


# -- the file's format --------------------------------------------------------
def test_names_and_units_keep_to_their_characters():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and c["source"].startswith("https://")
        assert len(c["source"]) <= 200 and c["file"].startswith("benchmark/")
    names = [e["name"] for g in ("end_to_end", "per_layer") for e in BENCH[g]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024 and 1 <= BENCH["run_seconds"] <= 51


def test_every_file_of_the_benchmark_is_under_its_path():
    assert BENCH["paths"] == ["benchmark"]
    for p in spec.PACKAGE_DIR.rglob("*"):
        rel = p.relative_to(spec.REPO_ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
