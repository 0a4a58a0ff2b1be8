"""The prover's three sparse products on the card: a CSR SpMV over Fr.

a_j = <A_j, w>, b_j = <B_j, w> and c_j = <C_j, w> for every row j of the
domain, in the H pipeline's input form: (3, 8, n) int32 limbs in Montgomery
form, zero past the system's constraints; out[0] is a, out[1] b, out[2] c,
each bit for bit ``FieldKernels.pack_bytes`` of the host products
(``SparseR1CS._products_into``).

The kernel, ``csrc/r1cs_spmv.cu``, replaces no Pallas kernel: the JAX
package computes these products in host C++ (``gosnark_sparse_matvec``).
Its note gives the design and the bound.  It reads:

  * :class:`RowCSR`, the rows of A, B and C over one domain, built once a
    constraint system and kept on the device (:func:`row_csr`): int32 row
    pointers and columns, and a 32-bit index a non-zero into a table of the
    system's distinct coefficients, each held as c·R mod r so that one
    product gives the plain c·w; index 0 is the coefficient 1, whose term
    takes no product.  A row's plain sum enters the Montgomery domain by one
    product with R^2.  Any coefficient in Fr works;
  * the witness as 32-byte rows, (m, 8) int32 plain canonical values: the
    bytes as they crossed to the device (:func:`.limbs.bytes_to_rows`).

Beside the kernel: :func:`r1cs_spmv_plain`, the plain PyTorch version of the
same function (vectorised over the non-zeros, a chunk of them at a time),
and the launch count ``SPMV.launches``.  On a CUDA tensor :func:`r1cs_spmv`
launches the kernel or raises; only a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..bn128 import constants as C
from ..profiling import IMADS_PER_MONT_MUL, LIMB_BYTES

__all__ = ["SPMV", "RowCSR", "row_csr", "r1cs_spmv", "r1cs_spmv_plain"]

SPMV = _build.Kernel(
    "SpMV r1cs_spmv",
    "r1cs_spmv",
    "gs_r1cs_spmv",
    [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "none: native/gosnark_native.cpp:178 (gosnark_sparse_matvec, the host products)",
)
WARP = 32  # a row of more terms than a warp has lanes takes a warp
PLAIN_CHUNK = 1 << 16  # non-zeros a step of the plain version
_R = (1 << 256) % C.R
_I32 = np.iinfo(np.int32).max


def _rows32(values) -> np.ndarray:
    """(k, 8) int32: each int below 2^256 as 32 little-endian bytes."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4").reshape(-1, 8).view(np.int32).copy()


@dataclass
class RowCSR:
    """The rows of A, B and C over a domain of n rows each, on one device:
    3n rows, A's then B's then C's, those past the constraints empty."""

    n: int
    indptr: torch.Tensor  # (3n + 1,) int32
    cols: torch.Tensor  # (nnz,) int32 signal indices
    coef: torch.Tensor  # (nnz,) int32 indices into table; 0 is the coefficient 1
    table: torch.Tensor  # (k, 8) int32: c·R mod r, 32 bytes a row
    r2: torch.Tensor  # (1, 8) int32: R^2 mod r
    long_rows: torch.Tensor  # (L,) int32: the rows of more than WARP terms
    n_signals: int

    def cost(self) -> dict:
        """What one call needs (``profiling.kernel_cost``'s keys): the
        products of the terms whose coefficient is not 1 and one a non-empty
        row; the bytes of the CSR, the table and the witness read once and
        of the output written once."""
        lens = self.indptr[1:] - self.indptr[:-1]
        products = int((self.coef != 0).sum()) + int((lens > 0).sum())
        nbytes = (4 * (self.indptr.numel() + self.cols.numel() + self.coef.numel() + self.long_rows.numel())
                  + LIMB_BYTES * (self.table.shape[0] + 1 + self.n_signals + 3 * self.n))
        return {"int32_ops": IMADS_PER_MONT_MUL * products, "bytes": nbytes, "products": products}


def _host_rows(r1cs):
    """(row lengths of A, B and C, columns, coefficient index, distinct
    coefficients mod r): over ``SparseR1CS._csr()``'s arrays where it has
    them, by ``np.unique``; else one pass over the rows' dicts."""
    r = C.R
    csr = r1cs._csr()
    if csr is not None:
        uniq, inv = np.unique(np.concatenate([v for _, _, v in csr]), return_inverse=True)
        return ([np.diff(ip) for ip, _, _ in csr], np.concatenate([c for _, c, _ in csr]), inv.reshape(-1),
                [int(u) % r for u in uniq])
    index, cols, inv, lens = {}, [], [], []
    for rows in (r1cs.A, r1cs.B, r1cs.C):
        lens.append(np.fromiter(map(len, rows), dtype=np.int64, count=len(rows)))
        for row in rows:
            for i, c in row.items():
                cols.append(i)
                inv.append(index.setdefault(c % r, len(index)))
    return lens, np.array(cols, dtype=np.int64), np.array(inv, dtype=np.int64), list(index)


def row_csr(r1cs, n: int, device) -> RowCSR:
    """``r1cs``'s rows over a domain of ``n`` rows, on ``device``: built on
    first use and kept on the system, one a (device, n), like
    ``SparseR1CS._csr()`` (the rows must not be edited after it)."""
    device = torch.device(device)
    cache = r1cs.__dict__.setdefault("_row_csr_cache", {})
    key = (str(device), n)
    if key in cache:
        return cache[key]
    if not len(r1cs.A) == len(r1cs.B) == len(r1cs.C) <= n:
        raise ValueError(f"{len(r1cs.A)}, {len(r1cs.B)}, {len(r1cs.C)} rows for a domain of {n}")
    lens, cols, inv, coeffs = _host_rows(r1cs)
    row_lens = np.zeros(3 * n, dtype=np.int64)
    for k, ln in enumerate(lens):
        row_lens[k * n : k * n + len(ln)] = ln
    if int(row_lens.sum()) > _I32 or r1cs.n_signals > _I32 or len(coeffs) >= _I32:
        raise ValueError("the system does not fit the kernel's 32-bit indices")
    if len(cols) and not 0 <= cols.min() <= cols.max() < r1cs.n_signals:
        raise ValueError(f"a row names a signal outside 0..{r1cs.n_signals - 1}")
    indptr = np.zeros(3 * n + 1, dtype=np.int64)
    np.cumsum(row_lens, out=indptr[1:])
    # the table's entry 0 is the coefficient 1; coefficient k of coeffs is
    # entry k + 1, or 0 where it is 1
    remap = np.array([0 if c == 1 else k + 1 for k, c in enumerate(coeffs)], dtype=np.int64)
    table = _rows32([_R] + [c * _R % C.R for c in coeffs])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
    out = cache[key] = RowCSR(
        n=n,
        indptr=to(indptr),
        cols=to(cols),
        coef=to(remap[inv]),
        table=to(table),
        r2=to(_rows32([_R * _R % C.R])),
        long_rows=to(np.flatnonzero(row_lens > WARP)),
        n_signals=r1cs.n_signals,
    )
    return out


def _check(csr: RowCSR, w_rows: torch.Tensor) -> None:
    if w_rows.dtype != torch.int32 or w_rows.dim() != 2 or w_rows.shape[1] != 8 or not w_rows.is_contiguous():
        raise ValueError(f"w_rows: expected contiguous (m, 8) int32, got {w_rows.dtype} {tuple(w_rows.shape)}")
    if w_rows.shape[0] != csr.n_signals:
        raise ValueError(f"w_rows: {w_rows.shape[0]} signals for a system of {csr.n_signals}")
    if w_rows.device != csr.indptr.device:
        raise ValueError(f"w_rows on {w_rows.device}, the rows on {csr.indptr.device}")


def r1cs_spmv(csr: RowCSR, w_rows: torch.Tensor) -> torch.Tensor:
    """(3, 8, n) int32: the Montgomery form of A·w, B·w and C·w over the
    domain, w the (m, 8) plain witness rows.  The kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    _check(csr, w_rows)
    if w_rows.device.type == "cpu":
        return r1cs_spmv_plain(csr, w_rows)
    if w_rows.data_ptr() % 16:
        raise ValueError("w_rows: the kernel reads 16-byte aligned rows")
    out = torch.empty((3, 8, csr.n), dtype=torch.int32, device=w_rows.device)
    SPMV.launch(
        csr.indptr.data_ptr(), csr.cols.data_ptr(), csr.coef.data_ptr(), csr.table.data_ptr(),
        csr.r2.data_ptr(), w_rows.data_ptr(), csr.long_rows.data_ptr(), csr.long_rows.numel(), WARP,
        out.data_ptr(), csr.n, _build.stream_ptr(w_rows),
    )
    return out


def r1cs_spmv_plain(csr: RowCSR, w_rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device).  Each term c·w is
    a Montgomery product of c·R by w (by R for the coefficient 1: w
    itself); the terms' limbs are summed by row as integers, the carries
    moved up into a ninth limb h, and the row sum S = l + h·2^256 enters
    the Montgomery domain as mont(l, R^2) + mont(h, R^3) = S·R mod r."""
    from .limbs import add_u64, consts, from_u64, to_u64
    from .mont_mul import mont_mul_u64

    r, dev, rows = C.R, w_rows.device, 3 * csr.n
    indptr = csr.indptr.to(torch.int64)
    row_of = torch.repeat_interleave(torch.arange(rows, device=dev), indptr[1:] - indptr[:-1])
    acc = torch.zeros((9, rows), dtype=torch.int64, device=dev)
    table = to_u64(csr.table.t())
    for s in range(0, csr.cols.numel(), PLAIN_CHUNK):
        cols, ci = csr.cols[s : s + PLAIN_CHUNK].long(), csr.coef[s : s + PLAIN_CHUNK].long()
        x = to_u64(w_rows[cols].t())
        k = (ci != 0).nonzero().squeeze(1)
        if k.numel():
            x[:, k] = mont_mul_u64(table[:, ci[k]], x[:, k], r)
        acc[:8].index_add_(1, row_of[s : s + PLAIN_CHUNK], x)
    for j in range(8):
        acc[j + 1] += acc[j] >> 32
        acc[j] &= 0xFFFFFFFF
    high = torch.zeros((8, rows), dtype=torch.int64, device=dev)
    high[0] = acc[8]
    const = lambda v: to_u64(torch.from_numpy(_rows32([v]).T.copy()).to(dev)).expand(8, rows)
    s = add_u64(mont_mul_u64(acc[:8], const(_R * _R % r), r), mont_mul_u64(high, const(pow(_R, 3, r)), r),
                consts(r, dev))
    return from_u64(s).view(8, 3, csr.n).permute(1, 0, 2).contiguous()
