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

K4 (``csrc/butterfly.cu``) replaces
``go_snark_study_tpu/ops/pallas_ntt.py::_butterfly_kernel`` (:40-47, built
by ``make_pallas_butterfly`` :132-161), one radix-2 DIT stage,
lo = e + o·tw, hi = e − o·tw.  The TPU kernel is a stage only because its
grid runs in order; on the card K4 has two forms:

  * :func:`radix2_ntt`, the whole-transform form: one launch computes the
    natural-order NTT of every row of (8, rows·n), n <= 2^13, bit for bit
    the stage loop :func:`radix2_stages`.  A row is one thread-block
    cluster of C = n/256 CTAs, at most 16 (8 where the card cannot place
    16; :func:`radix2_ntt_shape`), each holding n/C bit-reversed points in
    shared memory; the first log2(n/C) stages stay in a CTA, the last
    log2(C) read the partner CTA's tile through distributed shared memory.
    This is the form ``NTTEngine`` calls.
  * :func:`butterfly`, the stage form: one stage, lane by lane.  No path
    calls it; ``chip_smoke.py`` times the stage loop over it as the
    reading the whole-transform form replaced.

What bounds them on the H100: K3 bytes (with g = 16 it reads and writes
16×32 bytes per column and does 17 Montgomery products, ≈ 4,500 IMADs);
the K4 stage form bytes (5×32 bytes per lane for one product); the K4
whole-transform form its chain of dependent stages, on the C SMs of one
row's cluster.

Beside each: the plain PyTorch version (:func:`small_ntt_plain`,
:func:`radix2_ntt_plain`, :func:`butterfly_plain`) and the launch count
(``SMALL_NTT.launches``, ``RADIX2_NTT.launches``, ``BUTTERFLY.launches``).
On a CUDA tensor the wrappers launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

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
    "RADIX2_NTT",
    "radix2_ntt",
    "radix2_ntt_plain",
    "radix2_ntt_shape",
    "radix2_stages",
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
RADIX2_NTT = _build.Kernel(
    "K4 radix2_ntt",
    "butterfly",
    "gs_radix2_ntt",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
    "go_snark_study_tpu/ops/pallas_ntt.py:40",
)
RADIX2_MAX = 1 << 13  # largest whole transform K4 takes: one cluster a row
BUTTERFLY = _build.Kernel(
    "K4 stage",
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


def radix2_ntt(x: torch.Tensor, T: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """x: (8, rows·n) int32 Montgomery Fr, rows of n = ``length`` (default:
    all of x) contiguous; T: the (8, n/2) master table T[j] = w^j of
    ``NTTEngine.master``.  Returns the natural-order, unscaled n-point NTT of
    every row, 2 <= n <= 2^13."""
    check_limbs("x", x)
    if T.device != x.device:
        raise ValueError(f"x on {x.device} and T on {T.device}: different devices")
    check_limbs("T", T)
    if x.dim() != 2 or T.dim() != 2:
        raise ValueError(f"expected x (8, rows*n) and T (8, n/2), got {tuple(x.shape)}, {tuple(T.shape)}")
    total = x.shape[1]
    n = length or total
    if n < 2 or n > RADIX2_MAX or n & (n - 1) or total % n:
        raise ValueError(f"unsupported transform length {n} over {total} lanes")
    if T.shape[1] != n // 2:
        raise ValueError(f"T has {T.shape[1]} entries, expected n/2 = {n // 2}")
    if x.device.type == "cpu":
        return radix2_ntt_plain(x, T, n)
    out = torch.empty_like(x)
    RADIX2_NTT.launch(x.data_ptr(), out.data_ptr(), T.data_ptr(), n, total // n, _build.stream_ptr(x))
    return out


def radix2_ntt_shape(n: int, rows: int) -> dict:
    """K4's whole-transform launch for ``rows`` rows of n points as
    ``butterfly.cu`` computes it.  Builds the kernel library."""
    out = (ctypes.c_longlong * 5)()
    fn = _build._lib(RADIX2_NTT.source).gs_radix2_ntt_shape
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    if fn(n, rows, out) != 0:
        raise ValueError(f"no K4 launch for n={n}, rows={rows}")
    return dict(cluster=out[0], ctas=out[1], threads=out[2], shared_bytes=out[3], points_per_cta=out[4])


@functools.lru_cache(maxsize=None)
def _bitrev_index(n: int, total: int, device: torch.device) -> torch.Tensor:
    """Bit-reversal gather indices for rows of n over ``total`` lanes."""
    k = n.bit_length() - 1
    g = torch.arange(total, device=device)
    pos = g & (n - 1)
    rev = torch.zeros_like(pos)
    for b in range(k):
        rev = rev | (((pos >> b) & 1) << (k - 1 - b))
    return g - pos + rev


def radix2_stages(x: torch.Tensor, T: torch.Tensor, length: int | None, stage) -> torch.Tensor:
    """The radix-2 DIT stage loop of the JAX ``NTTEngine._transform``: a
    bit-reversal gather, then one ``stage(even, odd, tw) -> (lo, hi)`` call
    per stage over all n/2 pairs, with the gathers and the concatenation
    around it.  Natural order per row out."""
    total = x.shape[1]
    n = length or total
    k = n.bit_length() - 1
    if k == 0:
        return x
    x = x.index_select(1, _bitrev_index(n, total, x.device))
    half_iota = torch.arange(total // 2, device=x.device)
    for s in range(1, k + 1):
        m = 1 << s
        half = m // 2
        xr = x.reshape(8, total // m, m)
        even = xr[:, :, :half].reshape(8, total // 2).contiguous()
        odd = xr[:, :, half:].reshape(8, total // 2).contiguous()
        tw = T.index_select(1, (half_iota & (half - 1)) * (n // m))
        lo, hi = stage(even, odd, tw)
        x = torch.cat(
            [lo.reshape(8, total // m, half), hi.reshape(8, total // m, half)], dim=2
        ).reshape(8, total)
    return x


def radix2_ntt_plain(x: torch.Tensor, T: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4's whole-transform form: the stage loop
    over :func:`butterfly_plain` (any device, any power-of-two length)."""
    return radix2_stages(x, T, length, butterfly_plain)
