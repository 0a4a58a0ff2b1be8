"""One run of one cell: set-up, the measured window, the readings, the
comparison with the reference, and the result line.

The window is a closed loop with one client: request i is sent when
request i - 1 has returned, and the window closes at the end of the last
request sent before its deadline.  Each request ends with the card's queue
drained.  The program's spans (``GOSNARK_MSM_PROFILE``) are off in the
window of ``--trace 0``, and on in that of ``--trace 1``, where the span
readers read them (they fence the card).  After the traced window,
``torch.profiler`` records the traffic's ``trace_requests`` requests twice,
outside the window: first with the spans off, which the device readers
read, so that no fence lands in what they measure; then with the spans on,
only to name the idle gaps of the breakdown by the span the host was in.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import cost
from .spec import Cell
from .tracing import DeviceTrace, GcWatch, Profile, SpanLog
from .traffic import Traffic

FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "go_snark_study_tpu")


class SetupError(RuntimeError):
    """The run cannot measure: no card, too few cards, no native library."""


class NotMeasured(RuntimeError):
    """A metric that the cell declares read nothing in this run."""


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float = 0.0
    setup: Dict[str, float] = field(default_factory=dict)
    window: Tuple[float, float] = (0.0, 0.0)
    requests: List[Tuple[float, float]] = field(default_factory=list)  # (start, end) of each completed
    failed: int = 0
    points_per_request: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)  # label -> [seconds, calls] in the window
    span_intervals: List[Tuple[str, float, float]] = field(default_factory=list)  # the traced ones too
    gc_pauses: List[Tuple[float, float, int]] = field(default_factory=list)  # in the window
    trace: Optional[DeviceTrace] = None
    reruns: int = 0  # the program's degeneracy re-runs in the window
    card: Optional[dict] = None
    msm_works: List[dict] = field(default_factory=list)  # cost.msm_work of each profiled request

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def completed(self) -> int:
        return len(self.requests)

    def latencies(self) -> List[float]:
        return [b - a for a, b in self.requests]

    def per_request(self, *labels: str) -> Optional[float]:
        """Seconds of the spans ``labels`` per completed request, or None
        where no span of them was recorded."""
        if not self.completed or not any(lab in self.spans for lab in labels):
            return None
        return sum(self.spans.get(lab, [0.0])[0] for lab in labels) / self.completed

    def k1_ms_per_request(self) -> Optional[float]:
        if self.trace is None or not self.trace.requests:
            return None
        s = self.trace.k1_device_s()
        return None if s is None else s * 1e3 / self.trace.requests

    def msm_roofline_pct(self) -> Optional[float]:
        k1 = self.trace.k1_device_s() if self.trace is not None else None
        if not k1 or not self.msm_works or not self.card:
            return None
        return 100.0 * cost.least_seconds(self.msm_works, self.card["sm_clock_hz"])["seconds"] / k1

    def device_idle_pct(self) -> Optional[float]:
        if self.trace is None or self.trace.window_s() <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_TOP_LEVEL))


def count_wrong(system, answers: dict) -> int:
    """How many of ``answers`` {request index: answer in affine form}
    differ from the reference's."""
    want = system.expected(list(answers))
    return sum(answers[k] != want[k] for k in answers)


def _log(*a) -> None:
    print("[benchmark]", *a, file=sys.stderr, flush=True)


def _card_checks(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise SetupError("torch.cuda.is_available() is False: no card to measure on")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
    return torch.device("cuda:0")


def _native_check() -> None:
    from go_snark_study_tpu_torch import native

    if not native.available():
        raise SetupError("native/libgosnark_native.so is not built and `make -C native` could not build it: "
                         "the prover would take its Python route")


def _spans(on: bool) -> None:
    """The program's spans on or off from here on."""
    os.environ["GOSNARK_MSM_PROFILE"] = "1" if on else "0"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device=None) -> Tuple[dict, List[str]]:
    """Run ``cell`` once; return (the result line, the check lines).
    ``device`` None is the card, checked for; tests pass "cpu" (the
    program's plain kernels, no device readings).  Raises SetupError
    before measuring anything it cannot measure honestly, and NotMeasured
    where a metric the cell declares read nothing."""
    import torch

    on_card = device is None
    dev = _card_checks(cell.chips) if on_card else torch.device(device)
    _native_check()
    from go_snark_study_tpu_torch import profiling

    traffic = Traffic(cell.traffic, seed)
    run = Run(cell=cell)
    system = cell.system(cell.config, traffic, dev)
    old_env = os.environ.get("GOSNARK_MSM_PROFILE")
    with GcWatch() as gcw, SpanLog(profiling.PROFILER) as spans:
        _spans(False)
        run.setup = system.setup()
        system.request(-1)  # the cold request: every shape of the window, untimed
        run.points_per_request = getattr(system, "points_per_request", 0)
        _spans(trace)
        profiling.PROFILER.reset()
        answers: Dict[int, object] = {}
        reruns0 = system.reruns()
        gc.collect()
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        deadline, t_end, i = t0 + seconds, t0, 0
        while time.perf_counter() < deadline:
            a = time.perf_counter()
            try:
                answers[i] = system.request(i)
                t_end = time.perf_counter()
                run.requests.append((a, t_end))
            except Exception as e:  # noqa: BLE001 -- a failed request is counted, the window goes on
                t_end = time.perf_counter()
                run.failed += 1
                _log(f"request {i} failed: {type(e).__name__}: {e}")
            i += 1
        run.window = (t0, t_end)
        run.reruns = system.reruns() - reruns0
        run.gc_pauses = gcw.within(*run.window)
        dtrace = named = prof = None
        if trace and on_card:  # the traced requests follow the window, outside it
            k, prof = traffic.trace_requests, Profile()
            with prof.session():
                _spans(False)
                with prof.block("device", profiling.launch_counts) as dtrace:
                    for j in range(i, i + k):
                        system.request(j)
                _spans(True)
                with prof.block("named", profiling.launch_counts) as named:
                    for j in range(i + k, i + 2 * k):
                        system.request(j)
            dtrace.requests = k
            run.card = cost.read_card()
            run.msm_works = [w for j in range(i, i + k) for w in system.msm_works(j)]
    if old_env is None:
        os.environ.pop("GOSNARK_MSM_PROFILE", None)
    else:
        os.environ["GOSNARK_MSM_PROFILE"] = old_env
    run.span_intervals = spans.intervals
    run.spans = spans.totals(t0, t_end)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if prof is not None:
        prof.finish()
    run.trace = dtrace

    metrics, missing = {}, []
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]](run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            missing.append(m["name"])
    if missing:
        raise NotMeasured(f"{', '.join(missing)} read nothing in this run")

    attempted = run.completed + run.failed
    system.release()
    if on_card:
        torch.cuda.empty_cache()
    sample = traffic.sample(run.completed)
    done = sorted(answers)
    wrong = count_wrong(system, {done[j]: system.affine(answers[done[j]]) for j in sample})
    checks = {
        "wrong_answers": {"value": wrong, "limit": 0, "compared": len(sample)},
        "failed_requests": {"value": run.failed, "limit": 0, "attempted": attempted},
    }
    correct = wrong == 0 and run.failed == 0 and len(sample) > 0
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": int(peak)}
    if dtrace is not None:
        device_info["busy_s"] = dtrace.busy_s()
        device_info["window_s"] = dtrace.window_s()
    line = {"correct": correct, "attempted": attempted, "failed": run.failed, "metrics": metrics,
            "device": device_info}
    if dtrace is not None:
        line["breakdown"] = {"device_ops": dtrace.top_ops(),
                             "idle_gaps": named.idle_gaps(run.span_intervals, run.gc_pauses)}
    card = run.card or (cost.read_card() if on_card else None)
    if card:
        line["card"] = card
    line["setup"] = dict(run.setup, setup_s=run.setup_s)
    lat = sorted(run.latencies())
    line["requests"] = {"completed": run.completed, "window_s": run.window_s, "seed": seed,
                        "latency_s": {"min": lat[0], "p50": lat[len(lat) // 2], "max": lat[-1]} if lat else None,
                        "reruns_in_window": run.reruns,
                        "gc_pauses_in_window": len(run.gc_pauses),
                        "gc_pause_s_in_window": sum(p[1] for p in run.gc_pauses)}
    line["checks"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return line, lines
