"""Four-step (Bailey) NTT sharded over the ranks of a mesh.

Counterpart of ``go_snark_study_tpu/parallel/sharded_ntt.py``.  The size-n
transform is an (n1 x n2) matrix algorithm whose rows are spread over the
mesh's ranks, each rank holding n1/d rows of the natural-order input:

  A. distributed transpose (``all_to_all_single``) so original columns
     become local rows,
  B. local batched row NTTs of length n1,
  C. twiddle scaling by w^(k1*i2) (K2; each rank holds its rows of the
     table),
  D. distributed transpose back,
  E. local batched row NTTs of length n2.

The row NTTs are ``NTTEngine._transform`` over all of a rank's rows at once:
up to 2^13 points a row that is one K4 launch (at 2^16 over 2 ranks, 128
rows of 256).  The output is the standard four-step **permuted order**:
lane (k1, k2) holds X[k2*n1 + k1]; ``permutation()`` exposes it.
``inverse`` runs the mirrored steps with inverse roots and one 1/n scale
(K2), so forward -> pointwise -> inverse is an identity.

Every rank calls ``forward``/``inverse`` with the same (8, n) tensor,
transforms its own rows and returns the whole result (an ``all_gather`` of
the row blocks); ``forward_local``/``inverse_local`` keep the blocks
sharded.  On the 2-D ("host", "data") mesh the transposes run over the
flattened mesh, as JAX's all_to_all over the axis tuple does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..bn128 import constants as C
from ..ops.limbs import LIMBS, FieldKernels
from ..ops.ntt import NTTEngine
from .mesh import Mesh, all_gather, all_to_all

__all__ = ["FourStepNTT"]


class FourStepNTT:
    """Sharded NTT over Fr on ``mesh``."""

    def __init__(self, mesh: Mesh, engine: Optional[NTTEngine] = None):
        self.mesh = mesh
        self.eng = engine or NTTEngine(FieldKernels(C.R, mesh.device))
        self.K = self.eng.K
        self._tw_cache: Dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def split(self, n: int) -> Tuple[int, int]:
        k = n.bit_length() - 1
        n1 = 1 << (k // 2)
        n2 = n // n1
        d = self.mesh.size()
        assert n1 % d == 0 and n2 % d == 0, (
            f"four-step NTT needs device count {d} to divide both factors "
            f"({n1}, {n2}) of n={n}"
        )
        return n1, n2

    def _twiddle_table(self, n: int, inverse: bool) -> torch.Tensor:
        """(8, n2/d, n1) limbs, this rank's rows of T[i2, k1] =
        w^(+-k1*i2) (the step-C local layout: rows i2, columns k1)."""
        key = (n, inverse)
        if key not in self._tw_cache:
            n1, n2 = self.split(n)
            rows = n2 // self.mesh.size()
            lo = self.mesh.my_rank() * rows
            r = self.K.p
            w = self.eng.root_of_unity(n)
            if inverse:
                w = pow(w, -1, r)
            vals = []
            for i2 in range(lo, lo + rows):
                acc, step = 1, pow(w, i2, r)
                for _ in range(n1):
                    vals.append(acc)
                    acc = acc * step % r
            self._tw_cache[key] = self.K.pack(vals).reshape(LIMBS, rows, n1)
        return self._tw_cache[key]

    # ------------------------------------------------------------------
    def _a2a_transpose(self, x: torch.Tensor) -> torch.Tensor:
        """Local block (8, R/d, C) of a global (R, C) matrix -> (8, C/d, R)
        block of its transpose."""
        d = self.mesh.size()
        _, rows, cols = x.shape
        chunks = x.reshape(LIMBS, rows, d, cols // d).permute(2, 0, 1, 3)  # chunk j -> rank j
        got = all_to_all(chunks, self.mesh.flat_group)  # (d, 8, R/d, C/d), row i from rank i
        y = got.permute(1, 0, 2, 3).reshape(LIMBS, d * rows, cols // d)  # (8, R, C/d)
        return y.transpose(1, 2).contiguous()

    def _row_ntt(self, x: torch.Tensor, length: int, inverse: bool) -> torch.Tensor:
        rows = x.shape[1]
        flat = x.reshape(LIMBS, rows * length).contiguous()
        out = self.eng._transform(flat, self.eng.master(length, inverse), length)
        return out.reshape(LIMBS, rows, length)

    def _tw_mul(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        return self.K.mul(x.reshape(LIMBS, -1), tw.reshape(LIMBS, -1)).reshape(x.shape)

    # ------------------------------------------------------------------
    def forward_local(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """(8, n1/d, n2) natural-order rows of this rank -> its (8, n1/d, n2)
        block of the permuted evaluations."""
        n1, n2 = self.split(n)
        x = self._a2a_transpose(x)  # (8, n2/d, n1)
        x = self._row_ntt(x, n1, False)  # B
        x = self._tw_mul(x, self._twiddle_table(n, False))  # C
        x = self._a2a_transpose(x)  # (8, n1/d, n2)
        return self._row_ntt(x, n2, False)  # E

    def inverse_local(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """Exact inverse of :meth:`forward_local`."""
        n1, n2 = self.split(n)
        y = self._row_ntt(y, n2, True)  # E^-1 (unscaled)
        y = self._a2a_transpose(y)  # (8, n2/d, n1)
        y = self._tw_mul(y, self._twiddle_table(n, True))  # C^-1
        y = self._row_ntt(y, n1, True)  # B^-1 (unscaled)
        y = self._a2a_transpose(y)  # (8, n1/d, n2)
        ninv = self.K.pack([pow(n, -1, self.K.p)])
        return self.K.mul_const(y.reshape(LIMBS, -1), ninv).reshape(y.shape)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (8, n1/d, n2) rows of a whole (8, n) vector."""
        n = x.shape[1]
        n1, n2 = self.split(n)
        rows = n1 // self.mesh.size()
        lo = self.mesh.my_rank() * rows
        return x.reshape(LIMBS, n1, n2)[:, lo : lo + rows].contiguous()

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's row block -> the whole (8, n) vector, on every rank."""
        parts = all_gather(block, self.mesh.flat_group)
        return torch.cat(parts, dim=1).reshape(LIMBS, -1)

    # ------------------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (8, n) natural-order coefficients -> permuted evaluations
        (lane k1*n2+k2 holds X[k2*n1+k1])."""
        n = x.shape[1]
        return self.gather(self.forward_local(self.local_rows(x), n))

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        """Exact inverse of ``forward`` (permutation included)."""
        n = y.shape[1]
        return self.gather(self.inverse_local(self.local_rows(y), n))

    def permutation(self, n: int) -> np.ndarray:
        """perm[j] = natural-order index held by output lane j."""
        n1, n2 = self.split(n)
        lanes = np.arange(n)
        k1, k2 = lanes // n2, lanes % n2
        return k2 * n1 + k1
