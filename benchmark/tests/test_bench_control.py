"""The control, at a size a test run holds: the reference one bit narrower,
put where the program's answers go, has to come out not correct on every
seed, in every kind of cell."""

from __future__ import annotations

import json

import pytest

from benchmark import control
from benchmark.tests import cells

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return cells.make_root(tmp_path_factory.mktemp("ctl"), chain=64, points=330)


@pytest.mark.parametrize("workload", sorted(cells.TINY))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_caught(tiny_root, workload, seed):
    out = control.control_run(cells.load(tiny_root, workload), seed, 8)
    assert out["caught"] and out["wrong_answers"] == 8 and out["limit"] == 0


def test_reference_agrees_with_itself_at_full_width(tiny_root):
    """The same comparison with the reference in the program's place at
    full width finds nothing: the control is caught by its narrower scalars."""
    from benchmark.harness import count_wrong
    from benchmark.traffic import Traffic

    for workload in sorted(cells.TINY):
        cell = cells.load(tiny_root, workload)
        system = cell.system(cell.config, Traffic(cell.traffic, SEEDS[0]), None)
        assert count_wrong(system, system.expected(range(6))) == 0


def test_control_command(tiny_root, capsys, monkeypatch):
    cell = cells.load(tiny_root, "tiny-bits")
    monkeypatch.setattr(control.spec, "load_cell", lambda w: cell)
    assert control.main(["--workload", "tiny-bits", "--seeds", "5,6,7", "--requests", "4"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [5, 6, 7] and all(x["wrong_answers"] == 4 for x in lines)
