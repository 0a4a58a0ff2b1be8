"""What a run records beside its clock: collector pauses, the program's
spans with their intervals, and the device trace of a few requests.

* :class:`GcWatch`: every collection of CPython's collector (``gc.callbacks``),
  its start and length on ``time.perf_counter``'s clock.
* :class:`SpanLog`: the program's spans (``profiling.span``, recorded only
  with ``GOSNARK_MSM_PROFILE=1``) as intervals: each ``PROFILER.record``
  call logs its label, its end (now) and its start (now - seconds).
* :class:`Profile`: one ``torch.profiler`` session over marked blocks;
  each block gives a :class:`DeviceTrace`: its device operations (kernels,
  copies, sets) and its own interval, read from the exported Chrome trace,
  and the host clock at its start so that spans and collector pauses can
  be placed on the trace's clock.  (A second session in one process clears
  the first's events, so the blocks share one.)
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# K1: the port's point kernels (csrc/point_add.cu, msm_apply.cu,
# msm_seg_scan.cu, msm_reduce.cu), by their __global__ names
K1_KERNELS = ("point_add_kernel", "msm_apply_kernel", "msm_seg_step_kernel", "msm_reduce1_kernel",
              "msm_reduce2_kernel")
K1_COUNTERS = ("K1", "K1 apply", "K1 seg-scan", "K1 reduce")
MARK = "benchmark.profiled"  # a block's mark is MARK + "." + its name


class GcWatch:
    def __init__(self):
        self.pauses: List[Tuple[float, float, int]] = []  # (start, seconds, generation)
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((self._t0, time.perf_counter() - self._t0, info.get("generation", -1)))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def within(self, t0: float, t1: float) -> List[Tuple[float, float, int]]:
        return [p for p in self.pauses if t0 <= p[0] < t1]


class SpanLog:
    """Logs the intervals of ``profiler``'s records while entered."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.intervals: List[Tuple[str, float, float]] = []

    def __enter__(self):
        orig = self.profiler.record

        def record(label, seconds):
            now = time.perf_counter()
            self.intervals.append((label, now - seconds, now))
            orig(label, seconds)

        self.profiler.record = record
        return self

    def __exit__(self, *exc):
        del self.profiler.record  # the class's method again

    def totals(self, t0: float, t1: float) -> Dict[str, List[float]]:
        """{label: [seconds, calls]} of the spans that ended in [t0, t1]."""
        out: Dict[str, List[float]] = {}
        for label, a, b in self.intervals:
            if t0 <= b <= t1:
                s = out.setdefault(label, [0.0, 0])
                s[0] += b - a
                s[1] += 1
        return out


class Profile:
    """One ``torch.profiler`` session; :meth:`block` marks a stretch of it
    and returns its :class:`DeviceTrace`, filled in by :meth:`finish`."""

    def __init__(self):
        self.traces: List["DeviceTrace"] = []
        self._path: Optional[str] = None

    @contextmanager
    def session(self):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield self
        fd, self._path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(self._path)

    @contextmanager
    def block(self, name: str, counters):
        """Profile the block ``name``; ``counters()`` is read at both ends
        with the card's queue drained."""
        import torch
        from torch.profiler import record_function

        t = DeviceTrace(f"{MARK}.{name}")
        self.traces.append(t)
        torch.cuda.synchronize()
        t.counters_before = counters()
        with record_function(t.mark):
            t.host0 = time.perf_counter()
            yield t
            torch.cuda.synchronize()
        t.counters_after = counters()

    def finish(self) -> None:
        """Read the exported trace into each block's DeviceTrace (after the
        window: the parsing allocates much)."""
        try:
            with open(self._path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(self._path)
        for t in self.traces:
            t._read(events)


class DeviceTrace:
    """The device's operations during one marked block.

    After :meth:`Profile.finish`: ``ops`` [(name, cat, start_us, dur_us)]
    inside the block, ``span_us`` (start, end) of the block on the trace's
    clock, ``host0`` the host clock (``perf_counter``) at the block's start."""

    def __init__(self, mark: str = MARK):
        self.mark = mark
        self.ops: List[Tuple[str, str, float, float]] = []
        self.span_us: Optional[Tuple[float, float]] = None
        self.host0: Optional[float] = None
        self.requests = 0
        self.counters_before: Dict[str, int] = {}
        self.counters_after: Dict[str, int] = {}

    def _read(self, events) -> None:
        mark = [e for e in events if e.get("ph") == "X" and e.get("name") == self.mark
                and e.get("cat") == "user_annotation"]
        if not mark:
            raise RuntimeError(f"the profiler's trace has no {self.mark!r} annotation")
        t0 = float(mark[0]["ts"])
        t1 = t0 + float(mark[0]["dur"])
        self.span_us = (t0, t1)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                a, d = float(e["ts"]), float(e.get("dur", 0.0))
                if a + d > t0 and a < t1:
                    self.ops.append((e.get("name", "?"), e["cat"], a, d))
        self.ops.sort(key=lambda o: o[2])

    # -- readings ----------------------------------------------------------
    def host_to_us(self, t: float) -> float:
        return self.span_us[0] + (t - self.host0) * 1e6

    def window_s(self) -> float:
        return (self.span_us[1] - self.span_us[0]) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        block, as (start, end) in us."""
        t0, t1 = self.span_us
        out: List[List[float]] = []
        for _, _, a, d in self.ops:
            a, b = max(a, t0), min(a + d, t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def kernels(self, names=None) -> List[Tuple[str, str, float, float]]:
        return [o for o in self.ops if o[1] == "kernel" and (names is None or any(k in o[0] for k in names))]

    def k1_device_s(self) -> Optional[float]:
        """K1's device seconds, or None where the trace's K1 launches differ
        from the program's own count (an event the profiler dropped)."""
        ks = self.kernels(K1_KERNELS)
        counted = sum(self.counters_after.get(k, 0) - self.counters_before.get(k, 0) for k in K1_COUNTERS)
        if len(ks) != counted or not ks:
            return None
        return sum(o[3] for o in ks) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, _, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, spans: List[Tuple[str, float, float]], pauses, k: int = 10) -> List[list]:
        """The ``k`` longest stretches with no device operation inside the
        block, each named by what the host was in at its middle: a collector
        pause, else the innermost program span, else "outside spans"."""
        t0, t1 = self.span_us
        edges, prev = [], t0
        for a, b in self.intervals():
            if a > prev:
                edges.append((prev, a))
            prev = max(prev, b)
        if t1 > prev:
            edges.append((prev, t1))
        gaps = []
        for a, b in sorted(edges, key=lambda g: g[0] - g[1])[:k]:
            mid = (a + b) / 2
            name = "outside spans"
            for p0, d, gen in pauses:
                if self.host_to_us(p0) <= mid <= self.host_to_us(p0 + d):
                    name = f"gc.generation{gen}"
                    break
            else:
                inner = [(e - s, lab) for lab, s, e in spans if self.host_to_us(s) <= mid <= self.host_to_us(e)]
                if inner:
                    name = min(inner)[1]
            gaps.append([name, (b - a) / 1e6])
        return gaps
