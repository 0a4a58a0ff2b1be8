"""K3 and K4: the NTT kernels over Fr.

K3, :func:`small_ntt` (``csrc/small_ntt.cu``), replaces
``go_snark_study_tpu/ops/pallas_ntt.py::_small_ntt_kernel`` (:50-81, built
by ``make_pallas_small_ntt`` :84-129): a complete g-point DIT NTT
(2 <= g <= 16) along axis 1 of (8, g, L) Montgomery arrays.  Rows are read
bit-reversed, the j = 0 twiddle is skipped, and the output is in natural
order.  The stage twiddles are the g/2 powers w_g^k, a small table
argument.  A block of 256 threads owns 512/g columns and each thread runs
one butterfly of one column at every stage: the first stage reads its two
rows from device memory, the last writes its two rows back, and the
stages between go through a 16 KB shared-memory tile with a barrier after
each.  Every device-memory access of a warp is a full 128-byte line, and
the table is copied to shared memory (:func:`small_ntt_shape` gives the
launch).

K4, :func:`butterfly` (``csrc/butterfly.cu``), replaces
``go_snark_study_tpu/ops/pallas_ntt.py::_butterfly_kernel`` (:40-47, built
by ``make_pallas_butterfly`` :132-161): one radix-2 DIT stage,
lo = e + o·tw, hi = e − o·tw, lane by lane.

What bounds them on the H100: bytes.  K3 with g = 16 reads and writes
16×32 bytes per column and does 17 Montgomery products (≈ 4,500 IMADs);
K4 moves 5×32 bytes per lane for one product.  K4 is one lane per thread
with the limbs in registers; K3 keeps its stages in shared memory.  So
each element crosses device memory once per kernel, as the TPU kernels
kept theirs in VMEM.

Beside each: the plain PyTorch version (:func:`small_ntt_plain`,
:func:`butterfly_plain`) and the launch count (``SMALL_NTT.launches``,
``BUTTERFLY.launches``).  On a CUDA tensor the wrappers launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..bn128 import constants as C
from .mont_mul import check_limbs

__all__ = [
    "SMALL_NTT",
    "BUTTERFLY",
    "small_ntt",
    "small_ntt_plain",
    "small_ntt_shape",
    "butterfly",
    "butterfly_plain",
    "bitrev",
]

SMALL_NTT = _build.Kernel(
    "K3 small_ntt",
    "small_ntt",
    "gs_small_ntt",
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_void_p],
    "go_snark_study_tpu/ops/pallas_ntt.py:50",
)
BUTTERFLY = _build.Kernel(
    "K4 butterfly",
    "butterfly",
    "gs_butterfly",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p],
    "go_snark_study_tpu/ops/pallas_ntt.py:40",
)


def bitrev(n: int) -> list:
    k = n.bit_length() - 1
    return [int(format(i, f"0{k}b")[::-1], 2) if k else 0 for i in range(n)]


def small_ntt(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """x: (8, g, L) int32 Montgomery Fr; tw: (8, g/2) int32, tw[:, k] =
    w_g^k (w_g a primitive g-th root of unity, or its inverse for the
    inverse transform).  Returns the natural-order g-point NTT of every
    column."""
    check_limbs("x", x)
    check_limbs("tw", tw)
    if x.dim() != 3 or tw.dim() != 2:
        raise ValueError(f"expected x (8, g, L) and tw (8, g/2), got {tuple(x.shape)}, {tuple(tw.shape)}")
    g = x.shape[1]
    if g not in (2, 4, 8, 16) or tw.shape[1] != g // 2:
        raise ValueError(f"unsupported g={g} with a {tw.shape[1]}-entry table")
    if tw.device != x.device:
        raise ValueError("x and tw on different devices")
    if x.device.type == "cpu":
        return small_ntt_plain(x, tw)
    out = torch.empty_like(x)
    lanes = x.shape[2]
    if lanes:
        SMALL_NTT.launch(
            g, x.data_ptr(), out.data_ptr(), tw.data_ptr(), lanes, _build.stream_ptr(x)
        )
    return out


def small_ntt_shape(g: int, lanes: int) -> dict:
    """K3's launch for (g, L) as ``small_ntt.cu`` computes it: columns per
    block, threads per block, blocks.  Builds the kernel library."""
    out = (ctypes.c_longlong * 3)()
    fn = _build._lib(SMALL_NTT.source).gs_small_ntt_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    if fn(g, lanes, out) != 0:
        raise ValueError(f"no K3 launch for g={g}")
    return dict(cols=out[0], threads=out[1], blocks=out[2])


def small_ntt_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: bit-reversed rows, then log2(g) radix-2
    stages, each one batched product and one add/sub pair (any device)."""
    from .limbs import U64Field, from_u64, to_u64

    F = U64Field(C.R, x.device)
    g, lanes = x.shape[1], x.shape[2]
    u = to_u64(x)[:, bitrev(g), :]
    t = to_u64(tw)
    m = 2
    while m <= g:
        half = m // 2
        xr = u.reshape(8, g // m, m, lanes)
        e, o = xr[:, :, :half], xr[:, :, half:]
        w = t[:, [j * (g // m) for j in range(half)]]  # (8, half)
        prod = F.mul(o, w[:, None, :, None].expand(o.shape))
        u = torch.cat([F.add(e, prod), F.sub(e, prod)], dim=2).reshape(8, g, lanes)
        m *= 2
    return from_u64(u)


def butterfly(even: torch.Tensor, odd: torch.Tensor, tw: torch.Tensor):
    """One radix-2 DIT stage over Fr, lane by lane:
    (even + odd·tw, even − odd·tw).  All (8, ...) int32, one shape."""
    check_limbs("even", even)
    check_limbs("odd", odd, like=even)
    check_limbs("tw", tw, like=even)
    if even.device.type == "cpu":
        return butterfly_plain(even, odd, tw)
    lo, hi = torch.empty_like(even), torch.empty_like(even)
    n = even.numel() // 8
    if n:
        BUTTERFLY.launch(
            even.data_ptr(), odd.data_ptr(), tw.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), n, _build.stream_ptr(even),
        )
    return lo, hi


def butterfly_plain(even: torch.Tensor, odd: torch.Tensor, tw: torch.Tensor):
    """Plain PyTorch version of K4 (any device)."""
    from .limbs import U64Field, from_u64, to_u64

    F = U64Field(C.R, even.device)
    e = to_u64(even)
    t = F.mul(to_u64(odd), to_u64(tw))
    return from_u64(F.add(e, t)), from_u64(F.sub(e, t))
