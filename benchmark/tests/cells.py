"""Tiny cells for the CPU tests, added as files only: a copy of the
benchmark's files and ``BENCHMARK.json`` with three more configurations,
cells and metric entries, run on the program's plain kernels."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import spec

TINY = {
    "tiny-prove": ("tiny-chain", "closed-witness4", "prove-2e16"),
    "tiny-msm": ("tiny-msm", "closed-uniform4", "msm-2e20"),
    "tiny-bits": ("tiny-msm", "closed-num2bits1024", "msm-2e20-bits"),
}
SEED = 2**31 + 98765


def make_root(dst: Path, chain: int = 8, points: int = 64) -> Path:
    """``dst`` holding BENCHMARK.json and benchmark/ with the tiny cells;
    each tiny cell reports what the full cell it copies reports."""
    shutil.copytree(spec.PACKAGE_DIR, dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_json(spec.REPO_ROOT / "BENCHMARK.json")
    confs = dst / "benchmark" / "configs"
    c = spec.load_json(confs / "mulchain-2e20.json")
    c.update(name="tiny-chain", constraints=chain, signals=chain + 3, domain=chain)
    (confs / "tiny-chain.json").write_text(json.dumps(c))
    c = spec.load_json(confs / "msm-g1-2e20.json")
    c.update(name="tiny-msm", points=points)
    (confs / "tiny-msm.json").write_text(json.dumps(c))
    for name, key in (("tiny-chain", "constraints"), ("tiny-msm", "points")):
        bench["configs"].append({"name": name, "source": "https://example.org/tiny", "reduced": [key],
                                 "file": f"benchmark/configs/{name}.json", "why": "CPU test"})
    for cell, (conf, traffic, like) in TINY.items():
        bench["workloads"].append({"name": cell, "config": conf, "traffic": traffic, "chips": 1, "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def load(root: Path, cell: str) -> spec.Cell:
    return spec.load_cell(cell, root=root, bench_dir=root / "benchmark")
