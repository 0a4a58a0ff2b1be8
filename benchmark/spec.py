"""Finds a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` that its entry names (JSON), whose
  ``system`` names the module under ``benchmark/systems/`` that drives it;
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a metric, end-to-end or per-layer: ``benchmark/metrics/<name>.py``, a
  reader with ``read(run) -> float | None``; where there is no such file,
  the reader of the name's first part, ``<part>.py`` for ``<part>.<rest>``
  (one reader for ``k1_device_ms.prove`` and ``k1_device_ms.msm``).

A cell, a mix or a metric is added by adding files and entries; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    system: Callable  # the system module's ``System`` class
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    readers: Dict[str, Callable]  # metric name -> read(run)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _reader(metrics_dir: Path, name: str) -> Callable:
    path = metrics_dir / f"{name}.py"
    if not path.exists():
        path = metrics_dir / f"{name.split('.')[0]}.py"
    return _load_module(path, "benchmark_metric_" + path.stem.replace(".", "_")).read


def load_cell(workload: str, root: Path = REPO_ROOT, bench_dir: Path = PACKAGE_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read
    from ``bench_dir``; KeyError for an unknown name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    conf_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / conf_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    system = _load_module(bench_dir / "systems" / f"{config['system']}.py",
                          f"benchmark_system_{config['system']}").System
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layers = [m for m in bench["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: _reader(bench_dir / "metrics", m["name"]) for m in e2e + layers}
    return Cell(workload, config, traffic, int(w["chips"]), system, e2e, layers, readers)
