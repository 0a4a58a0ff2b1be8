"""The frozen yardstick of work: what an MSM has to compute, counted from
its inputs alone, and the H100's peaks at the clock the card reports.

Nothing here reads the program: no window width, group, chunk or launch
count of the engine enters a count.

* Work of one MSM of n points: the fewest mixed additions over window
  widths c of a Pippenger bucket method.  With scalars known, window w at
  width c costs its non-zero digits plus 2*2^c bucket additions if it has
  any digit (:func:`bucket_adds_exact`); scalars that span Fr cost
  ceil(254/c) * (n + 2*2^c) (:func:`bucket_adds_uniform`).  A mixed addition
  is 11 Montgomery products in G1 and 29 in G2, at 264 32-bit IMADs each
  (8 x 32-bit limbs: 8 x (16 x 2 + 1)).
* Bytes of one MSM: each input point (affine) and scalar read once, the
  result (one Jacobian point) written once.
* Least time: the larger of IMADs over 132 SMs x 64 IMADs a clock at the
  SM clock, and bytes over 3.35 TB/s of HBM3 (NVIDIA H100 SXM data sheet).
"""

from __future__ import annotations

import subprocess
from typing import Optional, Sequence

SCALAR_BITS = 254
IMADS_PER_PRODUCT = 264
FIELD_BYTES = 32
MIXED_ADD_PRODUCTS = {1: 11, 2: 29}  # G1, G2
COORDS = {1: 1, 2: 2}  # Fq elements per coordinate
H100_SMS = 132
H100_IMADS_PER_CLOCK_PER_SM = 64
H100_HBM_BYTES_PER_S = 3.35e12
WINDOW_RANGE = range(4, 25)


def bucket_adds_uniform(n: int, bits: int = SCALAR_BITS) -> int:
    """min over c of ceil(bits/c) * (n + 2*2^c)."""
    return min(-(-bits // c) * (n + 2 * (1 << c)) for c in WINDOW_RANGE)


def bucket_adds_exact(limbs) -> int:
    """min over c of the sum, over windows of width c, of the window's
    non-zero digits plus 2*2^c where it has one.  ``limbs``: (8, n)
    32-bit little-endian limbs, a torch tensor on any device (read as
    unsigned)."""
    import torch

    u = limbs.to(torch.int64) & 0xFFFFFFFF
    if u.shape[1] == 0:
        return 0
    nz_limbs = [int(k) for k in range(u.shape[0]) if bool(u[k].any())]
    top = 32 * nz_limbs[-1] + int(u[nz_limbs[-1]].max()).bit_length() if nz_limbs else 0
    best = None
    for c in WINDOW_RANGE:
        adds = 0
        for lo in range(0, top, c):
            k, sh = divmod(lo, 32)
            d = u[k] >> sh
            if sh + c > 32 and k + 1 < u.shape[0]:
                d = d | (u[k + 1] << (32 - sh))
            nz = int(torch.count_nonzero(d & ((1 << c) - 1)))
            if nz:
                adds += nz + 2 * (1 << c)
        best = adds if best is None else min(best, adds)
    return best


def msm_work(n: int, group: int, adds: int) -> dict:
    """IMADs and bytes of one MSM of ``n`` points in ``group`` (1 or 2)
    with ``adds`` mixed additions."""
    ops = adds * MIXED_ADD_PRODUCTS[group] * IMADS_PER_PRODUCT
    nbytes = n * (2 * COORDS[group] + 1) * FIELD_BYTES + 3 * COORDS[group] * FIELD_BYTES
    return {"int32_ops": ops, "bytes": nbytes}


def least_seconds(works: Sequence[dict], sm_clock_hz: float) -> dict:
    """The least time of ``works`` on one H100 at ``sm_clock_hz``: the
    larger of the IMADs over the IMAD peak and the bytes over the HBM peak."""
    ops = sum(w["int32_ops"] for w in works)
    nbytes = sum(w["bytes"] for w in works)
    t_ops = ops / (H100_SMS * H100_IMADS_PER_CLOCK_PER_SM * sm_clock_hz)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes), "bound": "operations" if t_ops >= t_bytes else "bytes",
            "int32_ops": ops, "bytes": nbytes}


def read_card(index: int = 0) -> Optional[dict]:
    """``nvidia-smi``'s name, SM clock (Hz), maximum SM clock and power
    limit (W) of card ``index``; None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
        name, sm, sm_max, limit = (x.strip() for x in out.split(","))
        return {"name": name, "sm_clock_hz": float(sm) * 1e6, "max_sm_clock_hz": float(sm_max) * 1e6,
                "power_limit_w": float(limit)}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None
