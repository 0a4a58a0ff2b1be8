"""NTT over the BN128 scalar field Fr.

Mirrors ``go_snark_study_tpu/ops/ntt.py`` (``NTTEngine``).  Fr has 2-adicity
28, so power-of-two domains up to 2^28 are supported.

  * Below ``FOURSTEP_MIN`` = 2^14 a transform is radix-2 decimation in
    time, all of it one launch of K4's whole-transform form
    (:func:`.ntt_kernels.radix2_ntt`): a thread-block cluster per row, the
    bit reversal and every stage inside the kernel.
  * From 2^14 up it is the four-step form: column NTTs, a twiddle product
    (K2), a transpose, column NTTs.  Every column transform is the
    recursive radix-16 ``_col_fused``, whose leaves are K3
    (:func:`.ntt_kernels.small_ntt`) with g <= 16 and whose inner twiddles
    are K2 products.  At 2^16 that is 4 K3 launches per transform.

The JAX package's ``GOSNARK_NTT_FUSED`` switch and its stage-at-a-time
column loop are not carried over: from 2^14 up every column length times
its lane count is a multiple of 16·1024, where the JAX package always
takes the fused path on the TPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..bn128 import constants as C
from .limbs import LIMBS, FieldKernels
from .ntt_kernels import radix2_ntt, small_ntt

__all__ = ["NTTEngine"]


class NTTEngine:
    """Forward/inverse NTT + coset helpers over Fr."""

    FOURSTEP_MIN = 1 << 14
    RADIX = 16  # rows per K3 launch: 17 Montgomery products per column

    def __init__(self, K: FieldKernels):
        assert K.p == C.R
        self.K = K
        self.r = K.p
        self._cache: Dict[tuple, torch.Tensor] = {}

    def _cached(self, key, make):
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = make()
        return t

    # ------------------------------------------------------------------
    def root_of_unity(self, n: int) -> int:
        assert n & (n - 1) == 0 and n.bit_length() - 1 <= C.TWO_ADICITY
        return pow(C.ROOT_OF_UNITY, 1 << (C.TWO_ADICITY - (n.bit_length() - 1)), self.r)

    def _root(self, n: int, inverse: bool) -> int:
        w = self.root_of_unity(n)
        return pow(w, -1, self.r) if inverse else w

    def master(self, n: int, inverse: bool) -> torch.Tensor:
        """Master twiddle table T[j] = w^±j, j < max(1, n/2), Montgomery
        limbs.  Stage s of a length-n transform uses T[j * (n >> s)]."""

        def make():
            w = self._root(n, inverse)
            vals, acc = [], 1
            for _ in range(max(1, n // 2)):
                vals.append(acc)
                acc = acc * w % self.r
            return self.K.pack(vals)

        return self._cached(("master", n, inverse), make)

    # ------------------------------------------------------------------
    def _transform(self, x: torch.Tensor, T: torch.Tensor, length: int | None = None):
        """x: (8, total) Montgomery limbs -> transformed, natural order per
        row.  ``T``: master twiddles for the per-row length; ``length``:
        per-transform length for row-batched use."""
        if (length or x.shape[1]) == 1:
            return x
        return radix2_ntt(x, T, length)

    # ------------------------------------------------------------------
    # four-step path
    # ------------------------------------------------------------------
    @staticmethod
    def split(n: int) -> Tuple[int, int]:
        k = n.bit_length() - 1
        n1 = 1 << (k // 2)
        return n1, n // n1

    def step_table(self, n: int, inverse: bool) -> torch.Tensor:
        """(8, n) twiddle table W[i1*n2 + i2] = w^(±i1·i2) for the middle
        scaling step."""

        def make():
            n1, n2 = self.split(n)
            w = self._root(n, inverse)
            r = self.r
            vals = []
            for i1 in range(n1):
                acc, step = 1, pow(w, i1, r)
                for _ in range(n2):
                    vals.append(acc)
                    acc = acc * step % r
            return self.K.pack(vals)

        return self._cached(("step", n, inverse), make)

    def small_table(self, g: int, inverse: bool) -> torch.Tensor:
        """(8, g/2) stage twiddles of the g-point K3 transform: w_g^k."""

        def make():
            w = self._root(g, inverse)
            return self.K.pack([pow(w, k, self.r) for k in range(g // 2)])

        return self._cached(("small", g, inverse), make)

    def _fused_tw(self, n_len: int, inverse: bool, a: int) -> torch.Tensor:
        """(8, a, b) table w^{±k1·i2} for the inner four-step twiddle."""

        def make():
            b = n_len // a
            w = self._root(n_len, inverse)
            vals = [pow(w, k1 * i2, self.r) for k1 in range(a) for i2 in range(b)]
            return self.K.pack(vals).reshape(LIMBS, a, b)

        return self._cached(("fused_tw", n_len, inverse, a), make)

    def _col_fused(self, x3: torch.Tensor, n_len: int, inverse: bool):
        """Recursive four-step column transform with radix-16 K3 leaves:
        natural order along axis 1 in and out (the identity
        w_n^a = w_{n/a} makes the sub-transforms use their canonical
        roots)."""
        b_lanes = x3.shape[2]
        if n_len <= self.RADIX:
            return small_ntt(x3.contiguous(), self.small_table(n_len, inverse))
        a = self.RADIX
        b = n_len // a
        y = self._col_fused(x3.reshape(LIMBS, a, b * b_lanes), a, inverse)
        y = y.reshape(LIMBS, a, b, b_lanes)
        tw = self._fused_tw(n_len, inverse, a)[..., None]
        y = self.K.mul(y, tw.expand(y.shape).contiguous())
        y = y.transpose(1, 2)  # (8, b, a, B)
        y = self._col_fused(y.reshape(LIMBS, b, a * b_lanes), b, inverse)
        return y.reshape(LIMBS, b, a, b_lanes).reshape(LIMBS, n_len, b_lanes)

    def _col_transform(self, x3: torch.Tensor, n_len: int, inverse: bool):
        """Length-``n_len`` NTTs along axis 1 of (8, n_len, B), batched over
        the minor axis, natural order in and out."""
        if n_len == 1:
            return x3
        return self._col_fused(x3, n_len, inverse)

    def _transform_fourstep(self, x: torch.Tensor, w_table: torch.Tensor, inverse: bool):
        """(8, n) -> (8, n) NTT in NATURAL order (no scaling): column NTTs
        over i1 -> W[i1·i2] twiddle -> transpose -> column NTTs over i2 ->
        flatten."""
        n = x.shape[1]
        n1, n2 = self.split(n)
        x3 = self._col_transform(x.reshape(LIMBS, n1, n2), n1, inverse)  # [k1, i2]
        x3 = self.K.mul(x3.reshape(LIMBS, n), w_table).reshape(LIMBS, n1, n2)
        x3 = x3.transpose(1, 2)  # [i2, k1]
        x3 = self._col_transform(x3.contiguous(), n2, inverse)  # [k2, k1]
        return x3.reshape(LIMBS, n)

    # -- unified entry ---------------------------------------------------
    def table(self, n: int, inverse: bool) -> torch.Tensor:
        """The data-sized table ``transform`` needs for domain n (master
        twiddles for radix-2, the W[i1·i2] step table for four-step)."""
        if n >= self.FOURSTEP_MIN:
            return self.step_table(n, inverse)
        return self.master(n, inverse)

    def transform(self, x: torch.Tensor, table: torch.Tensor, inverse: bool):
        """NTT (no 1/n scaling), natural order in and out; ``table`` must
        come from :meth:`table` for the same (n, inverse)."""
        if x.shape[1] >= self.FOURSTEP_MIN:
            return self._transform_fourstep(x, table, inverse)
        return self._transform(x, table)

    # ------------------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients -> evaluations on the size-n subgroup domain."""
        n = x.shape[1]
        return self.transform(x, self.table(n, False), False)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Evaluations -> coefficients (includes the 1/n scale)."""
        n = x.shape[1]
        y = self.transform(x, self.table(n, True), True)
        return self.K.mul_const(y, self.K.pack([pow(n, -1, self.r)]))

    # ------------------------------------------------------------------
    # coset helpers (on the coset g·H, Z(g w^i) = g^n - 1 is a nonzero
    # constant)
    # ------------------------------------------------------------------
    def coset_powers(self, n: int, g: int, inverse: bool) -> torch.Tensor:
        """(8, n) table g^i (or g^-i): coefficient i times it moves a
        polynomial to (or back from) the coset g·H."""

        def make():
            gg = pow(g, -1, self.r) if inverse else g
            pows, acc = [], 1
            for _ in range(n):
                pows.append(acc)
                acc = acc * gg % self.r
            return self.K.pack(pows)

        return self._cached(("coset", n, g, inverse), make)
