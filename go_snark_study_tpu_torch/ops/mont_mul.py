"""K2: batched Montgomery product, a·b·R⁻¹ mod p, for p = Fq or Fr.

Replaces ``go_snark_study_tpu/ops/pallas_field.py::_mont_mul_kernel``
(:44-84, built by ``make_pallas_mont_mul`` :87-119, dispatched from
``limbs.py:241-271``).  The kernel is ``csrc/mont_mul.cu``: one lane per
thread, 8×32-bit CIOS whose rows are PTX carry chains (``csrc/field.cuh``),
a canonical (< p) output, 128-thread blocks so that the 65,536 lanes of
the H pipeline are one even wave over the 132 SMs.

What bounds it on the H100: per lane it reads 2×32 bytes and writes 32
bytes, and does 8·(2·8 + 1) = 136 32×32→64-bit products (≈ 264 IMADs).
At 3.35 TB/s and 132 SMs × 64 IMAD/clk the byte time is the larger, so
the kernel is bandwidth-bound; its design keeps the limbs in registers and
reads each limb row with one coalesced load.

Beside the kernel: :func:`mont_mul_plain`, the plain PyTorch version of the
same function (the CPU tests run it, and ``chip_smoke.py`` holds the kernel
against it on the card), and the launch count ``MONT_MUL.launches``.  On a
CUDA tensor :func:`mont_mul` launches the kernel or raises; only a CPU
tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..bn128 import constants as C

__all__ = ["MONT_MUL", "mont_mul", "mont_mul_plain", "mont_mul_u64", "FIELD_IDS"]

M32 = 0xFFFFFFFF
M16 = 0xFFFF
FIELD_IDS = {C.Q: 0, C.R: 1}  # the moduli csrc/field.cuh knows

MONT_MUL = _build.Kernel(
    "K2 mont_mul",
    "mont_mul",
    "gs_mont_mul",
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_void_p],
    "go_snark_study_tpu/ops/pallas_field.py:44",
)


def n0_32(p: int) -> int:
    """-p^-1 mod 2^32, the CIOS quotient constant for 32-bit digits."""
    return (-pow(p, -1, 1 << 32)) % (1 << 32)


def check_limbs(name: str, t: torch.Tensor, like: torch.Tensor | None = None):
    """The checks every kernel wrapper makes on a limb tensor."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.dim() < 1 or t.shape[0] != 8:
        raise ValueError(f"{name}: expected shape (8, ...), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if like is not None:
        if t.device != like.device:
            raise ValueError(f"{name}: on {t.device}, expected {like.device}")
        if t.shape != like.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(like.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def mont_mul(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(8, ...) int32 Montgomery limbs × same -> same shape."""
    check_limbs("a", a)
    check_limbs("b", b, like=a)
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, p)
    out = torch.empty_like(a)
    n = a.numel() // 8
    if n:
        MONT_MUL.launch(
            FIELD_IDS[p], a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            _build.stream_ptr(a),
        )
    return out


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Plain PyTorch version of K2 on int32 limb tensors (any device)."""
    from .limbs import from_u64, to_u64

    return from_u64(mont_mul_u64(to_u64(a), to_u64(b), p))


def mont_mul_u64(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """CIOS Montgomery product on int64 tensors holding one 32-bit limb
    each, (8, ...) -> (8, ...).

    a is taken in 32-bit digits and b in 16-bit digits, so every partial
    product is < 2^48 and a column of the lazy accumulator (16-bit
    weights) stays < 2^53 over the 8 outer steps.  Step i owns columns
    2i..2i+15; its quotient digit m = t·(-p^-1) mod 2^32 comes from the
    low 32 bits t of the running value, and the carry out of its two
    retired columns moves up.  The result (< 2p) is normalised with two
    parallel carry passes and one carry-lookahead, then reduced below p."""
    from .limbs import consts, cond_sub_u64, resolve_carry

    c = consts(p, a.device)
    n0 = n0_32(p)
    shape = a.shape
    a = a.reshape(8, -1)
    b = b.reshape(8, -1)
    n = a.shape[1]
    b16 = torch.stack((b & M16, b >> 16), dim=1).reshape(16, n)
    prod = a.unsqueeze(1) * b16.unsqueeze(0)  # (8, 16, n), < 2^48
    p16 = c.p16.view(16, 1)
    acc = torch.zeros((32, n), dtype=torch.int64, device=a.device)
    for i in range(8):
        j = 2 * i
        win = acc[j : j + 16]
        win += prod[i]
        # only the low 32 bits of these two products matter, and int64
        # multiplication keeps them exactly when the high bits wrap
        t = (acc[j] + (acc[j + 1] << 16)) & M32
        m = (t * n0) & M32
        win += m * p16
        acc[j + 2] += (acc[j + 1] + (acc[j] >> 16)) >> 16
    r = acc[16:32]
    hi = r >> 16
    r = r & M16
    r[1:] += hi[:-1]  # hi[-1] == 0: the value is < 2^255
    c32 = r[0::2] + (r[1::2] << 16)
    for _ in range(2):
        hi = c32 >> 32
        c32 = c32 & M32
        c32[1:] += hi[:-1]
    s, _ = resolve_carry(c32, c)
    return cond_sub_u64(s, c).reshape(shape)
