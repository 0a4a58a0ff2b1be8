"""On the card: one short run of a cell through the command, and a traced
one.  Skips here; on the H100: python -m pytest -q -m gpu benchmark/tests"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(workload, trace):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(2**31 + 77),
                        "--seconds", "2", "--trace", str(trace)], cwd=spec.REPO_ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_msm_cell_on_card(card, trace):
    line = _run("msm-2e20", trace)
    cell = spec.load_cell("msm-2e20")
    want = cell.per_layer if trace else cell.end_to_end
    assert line["correct"] and set(line["metrics"]) == {m["name"] for m in want}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"] and line["breakdown"]["device_ops"]
