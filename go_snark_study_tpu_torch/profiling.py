"""The port's one tracer, its kernel launch counts and its cost model.

  * ``span(label, device)`` — a traced block of the program (the MSM engine's
    phases, the prover's phases, the setup's loops).  What it does is set by
    ``GOSNARK_MSM_PROFILE``:

      - unset or ``0``: nothing; the span yields after one lookup of the
        variable, records no CUDA event and opens no profiler range;
      - ``1``: fenced.  A span with a CUDA device drains the card's queue
        (``torch.cuda.synchronize``) at its end, so its host time holds its
        device work; the fences change the asynchronous dispatch;
      - ``events``: unfenced.  Nothing waits for the card; a span with a
        CUDA device records a CUDA event at each end on the current stream,
        and its device time is resolved when :meth:`Profiler.events` is read.

    In modes ``1`` and ``events`` every span calls ``PROFILER.record(label,
    seconds)`` at its end and appends one entry to the bounded log that
    ``PROFILER.events()`` reads as :class:`SpanEvent` records (host start
    and end on ``time.perf_counter``, parent span, request id, device ms);
    while a
    ``torch.profiler`` session runs, each span is also a
    ``record_function(label)`` range, a ``user_annotation`` on the
    profiler's own clock;
  * ``profiling()`` — turns ``GOSNARK_MSM_PROFILE=1`` on for a block, with
    a fresh ``PROFILER``, and restores the variable after it;
  * ``kernel_cost`` and ``CHIP_MODELS`` — the analytic cost of the port's
    kernels (32-bit IMADs and bytes moved) and the chips' attainable rates;
  * ``kernel_objects`` / ``reset_counts`` / ``launch_counts`` — every
    kernel of the port by its short name, and its launch count in this
    process.

Imports nothing beyond the standard library at module load; ``torch`` is
imported only inside a span that is on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

__all__ = [
    "Profiler",
    "PROFILER",
    "SpanEvent",
    "span",
    "profiling",
    "ChipModel",
    "CHIP_MODELS",
    "kernel_cost",
    "kernel_objects",
    "reset_counts",
    "launch_counts",
    "IMADS_PER_MONT_MUL",
    "POINT_PRODUCTS",
]


@dataclass(frozen=True)
class ChipModel:
    """``int32_tops``: attainable 32-bit integer multiply-adds per second;
    ``hbm_gbps``: memory bytes per second (the JAX package's field names,
    in the same units: per second, not tera or giga).  ``imads_per_clock``:
    IMADs the whole chip issues per SM clock, where the model has one."""

    name: str
    int32_tops: float
    hbm_gbps: float
    imads_per_clock: Optional[int] = None

    def at_clock(self, clock_hz: float) -> "ChipModel":
        """The same chip with its IMAD rate at another SM clock (for the
        clock ``nvidia-smi`` reports on the card at hand)."""
        assert self.imads_per_clock, f"{self.name} has no clock"
        return dataclasses.replace(self, int32_tops=self.imads_per_clock * clock_hz)

    def bound_s(self, nbytes: float, int32_ops: float):
        """(least seconds, "bytes" or "operations"): the larger of the bytes
        over the memory rate and the IMADs over the IMAD rate."""
        t_bytes = nbytes / self.hbm_gbps
        t_ops = int32_ops / self.int32_tops
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# H100 SXM: 132 SMs x 64 32-bit IMADs per clock per SM at the 1,980 MHz
# maximum SM clock, and 3.35 TB/s of HBM3.  Checked on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit, whose nvidia-smi reported that clock.
H100_SMS, H100_IMAD_PER_CLK_PER_SM, H100_MAX_SM_CLOCK_HZ = 132, 64, 1.98e9
CHIP_MODELS: Dict[str, ChipModel] = {
    "h100": ChipModel(
        "NVIDIA H100 SXM",
        int32_tops=H100_SMS * H100_IMAD_PER_CLK_PER_SM * H100_MAX_SM_CLOCK_HZ,
        hbm_gbps=3.35e12,
        imads_per_clock=H100_SMS * H100_IMAD_PER_CLK_PER_SM,
    ),
    "cpu": ChipModel("host CPU", int32_tops=0.1e12, hbm_gbps=50e9),
}

# csrc/field.cuh: a product of two 8 x 32-bit limb numbers is 8 x (16 wide
# products x 2 + 1) IMADs
IMADS_PER_MONT_MUL = 264
LIMB_BYTES = 32  # one field element
# Montgomery products per point operation: G1 mixed add 11, full add 16,
# doubling 7; G2 counts an Fq2 product as 3 and a square as 2
POINT_PRODUCTS = {
    ("point_add_mixed", 1): 11,
    ("point_add", 1): 16,
    ("point_double", 1): 7,
    ("point_add_mixed", 2): 29,
    ("point_add", 2): 43,
    ("point_double", 2): 16,
}


def _butterflies(g: int) -> int:
    """Products of a g-point radix-2 DIT transform, j = 0 butterflies
    skipped."""
    return sum(g // 2 - (g >> s) for s in range(1, g.bit_length()))


def kernel_cost(kind: str, n: int, group: int = 1, g: int = 16) -> dict:
    """Analytic per-call cost of the port's kernels at batch n:
    ``{"int32_ops": IMADs, "bytes": bytes moved, "products": Montgomery
    products}``.

    mont_mul (K2): 264 IMADs; reads two elements, writes one (3 x 32 B).
    point_add / point_add_mixed / point_double (K1), ``group`` 1 or 2:
    POINT_PRODUCTS products; a per-lane add reads two points and writes one
    (9 coordinates), a doubling six.  small_ntt (K3): n columns of a
    g-point transform, its j != 0 butterflies; reads and writes the columns
    and reads the g/2 twiddles.  radix2_ntt (K4): one n-point transform;
    reads and writes the row and reads n/2 twiddles.  butterfly (K4's stage
    form): n butterflies of one radix-2 stage, a product each; reads the
    even and odd halves and the twiddles, writes both halves.
    """
    if kind == "mont_mul":
        products, nbytes = n, 3 * LIMB_BYTES * n
    elif (kind, group) in POINT_PRODUCTS:
        coords = 6 if kind == "point_double" else 9
        products = POINT_PRODUCTS[kind, group] * n
        nbytes = coords * group * LIMB_BYTES * n
    elif kind == "small_ntt":
        products = _butterflies(g) * n
        nbytes = 2 * g * LIMB_BYTES * n + (LIMB_BYTES // 2) * g
    elif kind == "radix2_ntt":
        products = _butterflies(n)
        nbytes = 2 * LIMB_BYTES * n + LIMB_BYTES * (n // 2)
    elif kind == "butterfly":
        products, nbytes = n, 5 * LIMB_BYTES * n
    else:
        raise KeyError(kind)
    return {"int32_ops": IMADS_PER_MONT_MUL * products, "bytes": nbytes, "products": products}


def kernel_objects() -> dict:
    """Every kernel of the port by its short name: K1's per-lane form and
    its three MSM forms, K2, K3, K4's whole-transform form and its stage
    form, and the prover's sparse products (``SpMV``, which replaces no TPU
    kernel); each a ``_build.Kernel`` with a ``launches`` count."""
    from .ops.mont_mul import MONT_MUL
    from .ops.msm_kernels import APPLY, REDUCE, SEG_SCAN
    from .ops.ntt_kernels import BUTTERFLY, RADIX2_NTT, SMALL_NTT
    from .ops.point_add import POINT_ADD
    from .ops.r1cs_spmv import SPMV

    return {"K1": POINT_ADD, "K1 apply": APPLY, "K1 seg-scan": SEG_SCAN, "K1 reduce": REDUCE,
            "K2": MONT_MUL, "K3": SMALL_NTT, "K4": RADIX2_NTT, "K4 stage": BUTTERFLY, "SpMV": SPMV}


def reset_counts() -> None:
    """Every kernel's launch count in this process to 0, K1's per-instance
    counts included."""
    from .ops import point_add as pa

    for k in kernel_objects().values():
        k.launches = 0
    for key in pa.INSTANCE_LAUNCHES:
        pa.INSTANCE_LAUNCHES[key] = 0


def launch_counts() -> dict:
    """{short name: launches in this process since the last reset}."""
    return {name: k.launches for name, k in kernel_objects().items()}


MODE_VAR = "GOSNARK_MSM_PROFILE"
MODES = ("1", "events")  # the values that turn spans on
EVENT_LOG_LEN = 1 << 16  # events kept; the oldest go first


@dataclass
class SpanEvent:
    """One span that ended.  ``start`` and ``end``: ``time.perf_counter``
    at its two ends; ``span_id``: its own id, ``parent``: the enclosing
    span's id (None for a root); ``request``: the id of its root span's
    request, a new one for every span opened with no span open.
    ``device_ms`` (events mode, a span given a CUDA device): the stream's
    time between the CUDA events recorded at its two ends; where the host
    falls behind the card inside the span, the stream's own idle time there
    counts too.  None for a host-only span and in mode ``1``."""

    label: str
    start: float
    end: float
    span_id: int
    parent: Optional[int]
    request: int
    device_ms: Optional[float] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


def _resolved(entry: tuple) -> tuple:
    """A log entry with its pair of CUDA events, if it has one, turned into
    the milliseconds between them (waiting for the end one where the card
    has not reached it)."""
    marks = entry[-1]
    if not isinstance(marks, tuple):
        return entry
    marks[1].synchronize()
    return entry[:-1] + (marks[0].elapsed_time(marks[1]),)


class Profiler:
    """Span totals by label (``times``, ``calls``) and the event log.  The
    log holds plain tuples of numbers and strings, which CPython's collector
    stops tracking at its next collection, so that a long run's log adds
    nothing to a full collection's work; :meth:`events` makes the
    :class:`SpanEvent` records."""

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._events: Deque[tuple] = deque(maxlen=EVENT_LOG_LEN)  # SpanEvent's fields, device ms last
        self._ids = itertools.count()
        self._requests = itertools.count()
        self._open = threading.local()  # .stack: this thread's open (span id, request id), innermost last

    def record(self, label: str, seconds: float) -> None:
        self.times[label] += seconds
        self.calls[label] += 1

    def events(self) -> List[SpanEvent]:
        """The logged spans in the order they ended, each one's device time
        resolved (call after the caller's own synchronise: a span whose end
        event the card has not reached is waited for)."""
        entries = [_resolved(e) for e in self._events]
        self._events.clear()
        self._events.extend(entries)
        return [SpanEvent(*e) for e in entries]

    def reset(self) -> None:
        self.times.clear()
        self.calls.clear()
        self._events.clear()

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack


PROFILER = Profiler()


@contextmanager
def span(label: str, device=None, when: bool = True):
    """Trace the block under ``label`` (``when`` false: never) in the mode
    that ``GOSNARK_MSM_PROFILE`` sets (module docstring): off; ``1``, its
    end fenced on ``device`` where that is a CUDA device; ``events``, no
    fence and, on a CUDA device, its device time from two CUDA events.  On,
    the span logs a :class:`SpanEvent`, calls ``PROFILER.record(label,
    seconds)``, and, where a ``torch.profiler`` session was running when it
    opened, runs inside ``torch.profiler.record_function(label)`` (the range
    costs ~10 us of host time, so it is opened only where a trace takes
    it).  A block that raises records nothing."""
    mode = os.environ.get(MODE_VAR)
    if not (when and mode in MODES):
        yield
        return
    import torch

    cuda = device is not None and getattr(device, "type", device) == "cuda"
    stack = PROFILER._stack()
    parent, request = stack[-1] if stack else (None, next(PROFILER._requests))
    span_id = next(PROFILER._ids)
    marks = stream = None
    if cuda and mode == "events":
        stream = torch.cuda.current_stream(device)
        marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        marks[0].record(stream)
    annotate = torch._C._autograd._profiler_enabled()
    stack.append((span_id, request))
    t0 = time.perf_counter()  # outside the range, so the host interval holds its annotation
    try:
        with torch.profiler.record_function(label) if annotate else contextlib.nullcontext():
            yield
            if marks is not None:
                marks[1].record(stream)
            elif cuda:
                torch.cuda.synchronize(device)
    finally:
        stack.pop()
    t1 = time.perf_counter()
    PROFILER._events.append((label, t0, t1, span_id, parent, request, marks))
    PROFILER.record(label, t1 - t0)


@contextmanager
def profiling():
    """Run the block with ``GOSNARK_MSM_PROFILE=1`` and a fresh
    :data:`PROFILER` (yielded); the variable's earlier value, or its
    absence, is restored after the block."""
    old = os.environ.get(MODE_VAR)
    os.environ[MODE_VAR] = "1"
    PROFILER.reset()
    try:
        yield PROFILER
    finally:
        if old is None:
            del os.environ[MODE_VAR]
        else:
            os.environ[MODE_VAR] = old
