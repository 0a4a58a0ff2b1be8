"""The ``combine_ms`` reader on hand-built runs of both MSM cells."""

import pytest

from benchmark import harness, spec

MSM_CELLS = ("msm-2e20", "msm-2e20-bits")


@pytest.mark.parametrize("workload", MSM_CELLS)
def test_combine_ms_reads_the_span(workload):
    cell = spec.load_cell(workload)
    run = harness.Run(cell=cell, requests=[(0.0, 0.03)] * 4,
                      spans={"msm.plan": [0.02, 4], "msm.combine": [0.008, 4]})
    assert cell.readers["combine_ms.msm"](run) == pytest.approx(2.0)


@pytest.mark.parametrize("workload", MSM_CELLS)
def test_combine_ms_without_the_span_reads_each_request_after_its_last_span(workload):
    cell = spec.load_cell(workload)
    run = harness.Run(cell=cell, requests=[(0.0, 0.030), (0.030, 0.062)],
                      spans={"msm.plan": [0.008, 2], "msm.reduce": [0.042, 2]},
                      span_intervals=[("msm.plan", 0.001, 0.005), ("msm.reduce", 0.006, 0.027),
                                      ("msm.plan", 0.031, 0.035), ("msm.reduce", 0.036, 0.057),
                                      ("msm.plan", 0.070, 0.074)])  # a traced request's, after the window
    assert cell.readers["combine_ms.msm"](run) == pytest.approx(4.0)  # 3 and 5 ms
    run.spans, run.span_intervals = {}, []
    assert cell.readers["combine_ms.msm"](run) is None
