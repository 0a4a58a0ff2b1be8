"""Per-kernel profiling and speed-of-light accounting on the card.

Mirrors ``go_snark_study_tpu/profiling.py``.  This module provides:

  * ``timed(label, sync=None)`` — context manager accumulating wall times
    per label; device work is fenced with ``torch.cuda.synchronize`` on the
    device of the first tensor in ``sync`` (nothing to fence on the CPU);
  * ``kernel_cost`` — the analytic cost of the port's kernels (32-bit IMADs
    and bytes moved), from which ``speed_of_light`` derives the attainable
    time on a given chip;
  * ``report()`` — a table of measured times vs model;
  * ``span(label, device)`` — a ``timed`` block that records only when
    ``GOSNARK_MSM_PROFILE=1`` (the MSM hook of ``ops/msm.py`` and the
    prover's host phases use it);
  * ``kernel_objects`` / ``reset_counts`` / ``launch_counts`` — every
    kernel of the port by its short name, and its launch count in this
    process.

Imports nothing beyond the standard library at module load; ``torch`` is
imported only to fence.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = [
    "Profiler",
    "PROFILER",
    "timed",
    "span",
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
    form (each a ``_build.Kernel`` with a ``launches`` count)."""
    from .ops.mont_mul import MONT_MUL
    from .ops.msm_kernels import APPLY, REDUCE, SEG_SCAN
    from .ops.ntt_kernels import BUTTERFLY, RADIX2_NTT, SMALL_NTT
    from .ops.point_add import POINT_ADD

    return {"K1": POINT_ADD, "K1 apply": APPLY, "K1 seg-scan": SEG_SCAN, "K1 reduce": REDUCE,
            "K2": MONT_MUL, "K3": SMALL_NTT, "K4": RADIX2_NTT, "K4 stage": BUTTERFLY}


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


def _fence(sync) -> None:
    """Wait for the card to finish the work behind the first tensor found
    in ``sync`` (a tensor or a tuple/list/dict tree of them)."""
    import torch

    stack = [sync]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


class Profiler:
    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextmanager
    def timed(self, label: str, sync=None):
        """sync: optional tensor or tree of tensors whose device is
        synchronized before stopping the clock."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _fence(sync)
        self.times[label] += time.perf_counter() - t0
        self.calls[label] += 1

    def record(self, label: str, seconds: float) -> None:
        self.times[label] += seconds
        self.calls[label] += 1

    def report(self, chip: str = "h100") -> str:
        """Tabulate recorded timings; labels registered with a kernel kind
        (``label@kind:n``) also get their speed-of-light efficiency on
        ``chip``."""
        lines = [f"{'label':<36}{'calls':>6}{'total s':>10}{'per call':>12}"]
        for label in sorted(self.times):
            t, c = self.times[label], self.calls[label]
            row = f"{label:<36}{c:>6}{t:>10.3f}{t / c:>11.4f}s"
            if "@" in label:
                try:
                    kind, n = label.rsplit("@", 1)[1].split(":")
                    sol = self.speed_of_light(label, kind, int(n), chip)
                    row += f"  {100 * sol['efficiency']:5.1f}% SoL ({sol['bound']}-bound, {chip})"
                except (KeyError, ValueError):
                    pass
            lines.append(row)
        return "\n".join(lines)

    def speed_of_light(self, label: str, kind: str, n: int, chip: str = "h100") -> dict:
        """Efficiency of a measured kernel vs the chip's attainable rates."""
        model = CHIP_MODELS[chip]
        cost = kernel_cost(kind, n)
        t = self.times[label] / max(1, self.calls[label])
        t_sol, by = model.bound_s(cost["bytes"], cost["int32_ops"])
        return {
            "measured_s": t,
            "sol_s": t_sol,
            "bound": "memory" if by == "bytes" else "compute",
            "efficiency": t_sol / t if t > 0 else 0.0,
        }

    def reset(self) -> None:
        self.times.clear()
        self.calls.clear()


PROFILER = Profiler()
timed = PROFILER.timed


@contextmanager
def span(label: str, device=None, when: bool = True):
    """Record the block's wall time under ``label`` into :data:`PROFILER`,
    the card's queue drained at its end, when ``GOSNARK_MSM_PROFILE=1``
    (and ``when``); otherwise nothing.  For analysis runs: the fences
    change the asynchronous dispatch."""
    if not (when and os.environ.get("GOSNARK_MSM_PROFILE") == "1"):
        yield
        return
    t0 = time.perf_counter()
    yield
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize(device)
    PROFILER.record(label, time.perf_counter() - t0)
