"""The port's tracer (``profiling.span``, ``PROFILER``) in its three modes:
off, fenced (``GOSNARK_MSM_PROFILE=1``) and unfenced (``events``); the
event log's parents and request ids; the spans as ``torch.profiler``
annotations; and the MSM path's ``msm.flags`` and ``msm.combine`` spans.
CPU only: CUDA's events and stream are stood in for where a span is given
a CUDA device."""

import json
import time
import types

import pytest
import torch

from go_snark_study_tpu_torch import profiling
from go_snark_study_tpu_torch.ops import msm

CUDA = torch.device("cuda")


@pytest.fixture
def prof(monkeypatch):
    """A fresh PROFILER for the test."""
    p = profiling.Profiler()
    monkeypatch.setattr(profiling, "PROFILER", p)
    return p


class FakeEvent:
    """torch.cuda.Event's surface that a span uses; the device time between
    two is read from the fake clock at record time."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        self.waited = False

    def record(self, stream=None):
        FakeEvent.clock[0] += 1.5
        self.at = FakeEvent.clock[0]

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA events and the current stream stood in for; any synchronise
    raises."""

    def no_sync(*a, **k):
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)


def test_off_mode_records_nothing(prof, monkeypatch):
    """Unset or 0: no record, no event, no CUDA event, no profiler range."""

    def boom(*a, **k):
        raise AssertionError("an off span touched torch")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    for value in (None, "0"):
        if value is None:
            monkeypatch.delenv(profiling.MODE_VAR, raising=False)
        else:
            monkeypatch.setenv(profiling.MODE_VAR, value)
        with profiling.span("off", CUDA):
            with profiling.span("off.inner"):
                pass
    assert prof.events() == [] and not prof.calls and not prof.times


def test_fenced_mode_feeds_record_and_the_span_log(prof, monkeypatch):
    """Mode 1 fences a CUDA span once, calls PROFILER.record (looked up on
    the instance, so SpanLog's wrapper sees it), and logs events without
    device time."""
    from benchmark.tracing import SpanLog

    fences = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: fences.append(device))
    monkeypatch.setenv(profiling.MODE_VAR, "1")
    with SpanLog(prof) as log:
        with profiling.span("outer", CUDA):
            with profiling.span("inner"):
                time.sleep(0.002)
    assert fences == [CUDA]
    assert prof.calls == {"outer": 1, "inner": 1}
    assert [lab for lab, _, _ in log.intervals] == ["inner", "outer"]
    (_, a_in, b_in), (_, a_out, b_out) = log.intervals
    assert a_out <= a_in < b_in <= b_out and b_in - a_in >= 0.002
    assert log.totals(a_out, b_out + 1)["outer"][1] == 1
    assert [e.device_ms for e in prof.events()] == [None, None]
    assert "record" not in vars(prof)  # SpanLog put the class's method back


def test_events_mode_never_synchronizes(prof, monkeypatch, fake_cuda):
    """events: a CUDA span records two CUDA events and never fences; its
    device time is resolved when the log is read; a host span has none.
    With no profiler session running, no profiler range is opened."""

    def no_range(*a, **k):
        raise AssertionError("a profiler range with no session")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setenv(profiling.MODE_VAR, "events")
    with profiling.span("dev", CUDA):
        with profiling.span("host"):
            pass
    raw = list(prof._events)
    assert [type(m) for m in raw[1][-1]] == [FakeEvent, FakeEvent]  # not yet resolved
    ev = {e.label: e for e in prof.events()}
    assert ev["dev"].device_ms == pytest.approx(1.5)
    assert list(prof._events)[1][-1] == pytest.approx(1.5)  # resolved in the log, the CUDA events let go
    assert ev["host"].device_ms is None
    assert prof.calls == {"dev": 1, "host": 1}


def test_parents_and_request_ids(prof, monkeypatch):
    """Children name their parent and share the root's request id; a new
    root starts a new request; a span that raises records nothing and is
    closed all the same."""
    monkeypatch.setenv(profiling.MODE_VAR, "events")
    with profiling.span("a"):
        with profiling.span("a.b"):
            with profiling.span("a.b.c"):
                pass
        with profiling.span("a.d"):
            pass
    with pytest.raises(ValueError):
        with profiling.span("bad"):
            raise ValueError
    with profiling.span("e"):
        pass
    ev = {e.label: e for e in prof.events()}
    assert list(ev) == ["a.b.c", "a.b", "a.d", "a", "e"]
    assert ev["a"].parent is None and ev["e"].parent is None
    assert ev["a.b"].parent == ev["a.d"].parent == ev["a"].span_id
    assert ev["a.b.c"].parent == ev["a.b"].span_id
    assert len({ev[k].request for k in ("a", "a.b", "a.b.c", "a.d")}) == 1
    assert ev["e"].request != ev["a"].request
    assert all(e.start <= e.end for e in ev.values())
    assert ev["a"].start <= ev["a.b"].start <= ev["a.b.c"].end <= ev["a.d"].start <= ev["a"].end
    prof.reset()
    assert prof.events() == [] and not prof.calls


def test_event_log_leaves_the_collector(prof, monkeypatch):
    """A fenced span's log entry holds no object that CPython's collector
    tracks after a collection, so that the log does not bring a full
    collection forward."""
    import gc

    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setenv(profiling.MODE_VAR, "1")
    with profiling.span("root", CUDA):
        with profiling.span("child"):
            pass
    gc.collect()
    assert len(prof._events) == 2 and not any(gc.is_tracked(e) for e in prof._events)


def test_event_log_is_bounded(prof, monkeypatch):
    monkeypatch.setenv(profiling.MODE_VAR, "events")
    monkeypatch.setattr(prof, "_events", type(prof._events)(maxlen=3))
    for i in range(5):
        with profiling.span(f"s{i}"):
            pass
    assert [e.label for e in prof.events()] == ["s2", "s3", "s4"]
    assert prof.calls["s0"] == 1


@pytest.mark.parametrize("mode", ["1", "events"])
def test_spans_are_profiler_annotations(prof, monkeypatch, tmp_path, mode):
    """Under a CPU torch.profiler session every span is a user_annotation
    of its label, lasting its event's host time to within 1 ms (after a
    first span that takes the profiler's first-range set-up)."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv(profiling.MODE_VAR, mode)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with profiling.span("first"):
            pass
        with profiling.span("root"):
            with profiling.span("root.work"):
                torch.ones(64).sum()
                time.sleep(0.003)
            with profiling.span("root.more"):
                time.sleep(0.001)
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    notes = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    events = prof.events()
    assert sorted(e["name"] for e in notes) == sorted(e.label for e in events)
    for e in events[1:]:
        (note,) = [n for n in notes if n["name"] == e.label]
        assert abs(float(note["dur"]) / 1e3 - e.seconds * 1e3) < 1.0, (e.label, note["dur"], e.seconds)


def test_msm_flags_and_combine_spans(prof, monkeypatch):
    """window_sums_checked's flag read and re-run are ``msm.flags`` (none
    for a complete engine, which reads no flag); combine_window_sums is
    ``msm.combine`` whoever calls it, here a child of ``prove.combine``."""
    monkeypatch.setenv(profiling.MODE_VAR, "events")
    reruns = []
    twin = types.SimpleNamespace(window_sums_eager=lambda *a: reruns.append(a) or ("again", None))
    eng = types.SimpleNamespace(complete=False, device=torch.device("cpu"), fallback_hits=0,
                                window_sums_eager=lambda *a: ("sums", torch.tensor(True)),
                                fallback_engine=lambda: twin,
                                rerun_if_flagged=lambda *a: msm.MSMEngine.rerun_if_flagged(eng, *a))
    assert msm.MSMEngine.window_sums_checked(eng, "pts", "limbs", 4) == "again"
    assert eng.fallback_hits == 1 and len(reruns) == 1
    eng.complete = True
    assert msm.MSMEngine.window_sums_checked(eng, "pts", "limbs", 4) == "sums"

    ints = types.SimpleNamespace(zero=lambda: 0, double=lambda x: 2 * x, add=lambda x, y: x + y)
    assert msm.combine_window_sums(ints, [1, 2, 3], 2) == 1 + 2 * 4 + 3 * 16
    with profiling.span("prove.combine"):
        msm.combine_window_sums(ints, [5], 3)
    ev = prof.events()
    assert [e.label for e in ev] == ["msm.flags", "msm.combine", "msm.combine", "prove.combine"]
    assert ev[0].parent is None and ev[1].parent is None
    assert ev[2].parent == ev[3].span_id and ev[2].request == ev[3].request


def test_prove_rerun_span_and_counts(prof, monkeypatch):
    """A flag forced on one MSM of a proof (C's private MSM): one
    ``prove.rerun`` under ``prove.flags``, and ``rerun_counts`` bumped for
    that MSM only; with the spans off the count moves all the same and
    nothing is recorded."""
    import random

    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    fast = FastGroth16(device="cpu")
    r1cs = mul_chain_r1cs(8, seed=1)
    pk = fast.setup(r1cs, rng=random.Random(3), materialize_host=False).pk
    target = pk._device.cdelta
    orig = msm.MSMEngine.window_sums_eager

    def forced(self, pts, limbs, c, plans=None):
        sums, _ = orig(self, pts, limbs, c, plans)
        return sums, torch.tensor(pts is target and not self.complete)

    monkeypatch.setattr(msm.MSMEngine, "window_sums_eager", forced)
    monkeypatch.setenv(profiling.MODE_VAR, "events")
    fast.prove(r1cs, pk, rng=random.Random(4))
    ev = prof.events()
    reruns = [e for e in ev if e.label == "prove.rerun"]
    (flags,) = [e for e in ev if e.label == "prove.flags"]
    assert len(reruns) == 1 and reruns[0].parent == flags.span_id
    assert fast.rerun_counts == {"at": 0, "b1": 0, "cd": 1, "h": 0, "b2": 0}

    prof.reset()
    monkeypatch.setenv(profiling.MODE_VAR, "0")
    fast.prove(r1cs, pk, rng=random.Random(5))
    assert prof.events() == [] and not prof.calls
    assert fast.rerun_counts == {"at": 0, "b1": 0, "cd": 2, "h": 0, "b2": 0}
    assert fast.msm_g1.fallback_hits == 2 and fast.msm_g2.fallback_hits == 0
