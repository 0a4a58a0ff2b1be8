"""Batched fixed-base scalar multiplication.

Mirrors ``go_snark_study_tpu/ops/fixed_base.py`` (``FixedBaseEngine``).  The
trusted setup commits thousands of scalars to the SAME base point (the G1
or G2 generator).  The classic windowed table

    table[w][d] = d * 2^(8w) * G      (32 windows x 256 digits)

is built once per base on the host with the copied host curve, packed as a
limb tensor, and every scalar then costs one gather + one K1 full add per
window, all lanes at once.  The JAX package cuts the lanes into fixed tiles
to bound its compile count; lanes are independent, so the port runs them
in one pass.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .curve_ops import tree_map
from .msm import NUM_WINDOWS, WINDOW_BITS, scalars_to_windows

__all__ = ["FixedBaseEngine"]

DIGITS = 1 << WINDOW_BITS


class FixedBaseEngine:
    """Windowed fixed-base multiplier for one base point in one group."""

    def __init__(self, batch_group, host_group, base_point, scalar_modulus: int):
        self.bg = batch_group
        self.host_group = host_group
        self.r = scalar_modulus
        self._table = self._build_table(base_point)

    def _build_table(self, base):
        g = self.host_group
        table: List = []
        window_base = base
        for _ in range(NUM_WINDOWS):
            row = [g.zero()]
            for _ in range(DIGITS - 1):
                row.append(g.add(row[-1], window_base))
            table.extend(row)
            for _ in range(WINDOW_BITS):
                window_base = g.double(window_base)
        # pack flat: index w*256 + d
        return self.bg.pack(table)

    def batch_mul_device(self, windows: torch.Tensor):
        """(32, N) digits -> batched Jacobian point pytree with N lanes:
        one gather and one K1 ``jadd`` per window."""
        n = windows.shape[1]
        acc = self.bg.zeros(n)
        for w in range(NUM_WINDOWS):
            idx = windows[w].long() + w * DIGITS
            pt = tree_map(lambda c: c.index_select(1, idx), self._table)
            acc = self.bg.jadd(acc, pt)
        return acc

    def batch_mul(self, scalars: Sequence[int]):
        """[k_i] -> [k_i * G] as host Jacobian points."""
        n = len(scalars)
        if n == 0:
            return []
        windows = scalars_to_windows(scalars, self.r, self.bg.K.device)
        return self.bg.unpack(self.batch_mul_device(windows))[:n]

