"""Batched 254-bit modular arithmetic: 8 x 32-bit limbs in int32 lanes.

Mirrors ``go_snark_study_tpu/ops/limbs.py`` (``FieldKernels``).  The value
stored for a field element is the same canonical Montgomery integer as in
the JAX package (R = 2^256 mod p, value < p); only the storage differs:

  * **(8, N) int32, 32-bit limbs, limb-major.**  Thread i of a CUDA kernel
    reads limb j of lane i at ``j*N + i``, so every limb row is one
    coalesced load.  The int32 holds the limb's bit pattern (limbs >= 2^31
    read back negative); the JAX package stores (32, N) int32 8-bit limbs,
    4x the bytes.  :mod:`..interop` converts between the two layouts.
  * Every Montgomery product on a CUDA tensor launches the hand-written
    kernel K2 (:mod:`.mont_mul`), whatever the batch size.  Add, sub and
    negation are plain PyTorch here, as they were plain XLA in the JAX
    package.
  * The plain arithmetic works on int64 copies holding one 32-bit limb
    each (the ``u64`` helpers below); carries and borrows are resolved with
    a carry-lookahead on a per-lane 9-bit word instead of an 8-step chain,
    so one modular add is ~40 tensor ops whatever the lane count.

Any trailing shape works: every op is lane-independent and the limb axis
is axis 0.

Host bridge (the JAX package's ``pack``/``unpack`` over its C++ runtime):
values cross to the device as canonical little-endian 32-byte values
(:func:`..native.ints_to_bytes`, or the C++ sparse product's output; the
prover's pinned staging buffer), one copy, relaid into limbs on the device
(:func:`bytes_to_limbs`), and enter the Montgomery domain there by one
product by R^2 (:meth:`FieldKernels.to_mont`, K2 on the card).  The
prover's witness keeps its rows as they crossed (:func:`bytes_to_rows`)
for the SpMV (:mod:`.r1cs_spmv`).  The host's Python Montgomery conversion
(:meth:`FieldKernels.pack_python`) is the bridge's plain version.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence

import numpy as np
import torch

from .. import native
from . import mont_mul as _mm

__all__ = ["LIMBS", "LIMB_BITS", "FieldKernels", "U64Field", "resolve_device", "bytes_to_limbs", "bytes_to_rows",
           "rows_to_limbs"]

LIMBS = 8
LIMB_BITS = 32
M32 = 0xFFFFFFFF


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Without one that raises: the port runs on
    the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions"
            )
        device = "cuda"
    return torch.device(device)


def ints_to_limbs_np(xs: Sequence[int]) -> np.ndarray:
    """python ints (each < 2^256) -> (8, N) int32 limb array (little-endian
    32-bit limbs, limb-major)."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(xs), LIMBS)
    return np.array(arr.T, order="C").view(np.int32)


def bytes_to_rows(buf, device) -> torch.Tensor:
    """32-byte little-endian values -> (N, 8) int32 on ``device``, a value a
    row: the bytes as they are, one copy.  ``buf``: ``bytes``, or a 1-D
    uint8 host tensor (a pinned one crosses by a non-blocking copy: the
    caller keeps it unchanged until the copy has run; on the CPU the rows
    are a view of it)."""
    size = buf.numel() if isinstance(buf, torch.Tensor) else len(buf)
    if size % 32:
        raise ValueError(f"{size} bytes: expected 32 a value")
    staged = isinstance(buf, torch.Tensor)
    if staged:
        raw = buf.view(torch.int32)
    elif size:
        with warnings.catch_warnings():  # a read-only buffer: it is only read
            warnings.simplefilter("ignore", UserWarning)
            raw = torch.frombuffer(buf, dtype=torch.int32)
    else:
        raw = torch.zeros(0, dtype=torch.int32)
    return raw.to(device, non_blocking=staged).view(-1, LIMBS)


def rows_to_limbs(rows: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """(N, 8) value rows -> the (8, lanes) limb tensor on their device, zero
    padded (``lanes`` defaults to N): the rows transposed into the zero
    tensor."""
    n = rows.shape[0]
    lanes = n if lanes is None else lanes
    if lanes < n:
        raise ValueError(f"{n} values: expected at most {lanes}")
    out = torch.zeros((LIMBS, lanes), dtype=torch.int32, device=rows.device)
    out[:, :n] = rows.t()
    return out


def bytes_to_limbs(buf, device, lanes: int | None = None) -> torch.Tensor:
    """32-byte little-endian values -> (8, lanes) int32 limb tensor on
    ``device``, zero padded (``lanes`` defaults to the value count): the
    bytes copied to the device as they are (:func:`bytes_to_rows`) and
    relaid there (:func:`rows_to_limbs`).  No Montgomery product: the limbs
    hold the values."""
    return rows_to_limbs(bytes_to_rows(buf, device), lanes)


def limbs_np_to_ints(arr: np.ndarray) -> List[int]:
    a = np.ascontiguousarray(np.asarray(arr).view(np.uint32).T).astype("<u4")
    return [int.from_bytes(row.tobytes(), "little") for row in a]


# ---------------------------------------------------------------------------
# plain int64 helpers: limbs held one per int64, values in [0, 2^32)
# ---------------------------------------------------------------------------
class _Consts:
    """Per-(modulus, device) constant tensors for the plain arithmetic."""

    def __init__(self, p: int, device: torch.device):
        self.k8 = torch.arange(LIMBS, dtype=torch.int64, device=device)
        self.w8 = torch.ones(LIMBS, dtype=torch.int64, device=device) << self.k8
        pl = [(p >> (32 * i)) & M32 for i in range(LIMBS)]
        self.p = torch.tensor(pl, dtype=torch.int64, device=device)
        p16 = [(p >> (16 * i)) & 0xFFFF for i in range(16)]
        self.p16 = torch.tensor(p16, dtype=torch.int64, device=device)


_CONSTS = {}


def consts(p: int, device) -> _Consts:
    key = (p, str(device))
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = _Consts(p, torch.device(device))
    return c


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(8,) constant -> (8, 1, ..., 1) for broadcasting over ``ndim`` dims."""
    return t.view((LIMBS,) + (1,) * (ndim - 1))


def to_u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def from_u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)  # wraps limbs >= 2^31 to their int32 pattern


def lookahead(g: torch.Tensor, p: torch.Tensor, c: _Consts):
    """Carry (or borrow) resolution for 8 limbs at once.  ``g``: the limb
    generates a carry whatever comes in; ``p``: it passes an incoming carry
    on.  Returns (carry into each limb (8, ...) int64, carry out of the top
    (...)).  With X = g|p and Y = g as 8-bit words, the carries are
    (X + Y) ^ X ^ Y — the adder's own carry chain does the propagation."""
    gi = g.to(torch.int64)
    w = _col(c.w8, g.dim())
    x = ((gi | p.to(torch.int64)) * w).sum(0)
    y = (gi * w).sum(0)
    cin = (x + y) ^ x ^ y
    return (cin.unsqueeze(0) >> _col(c.k8, g.dim())) & 1, cin >> LIMBS


def resolve_carry(s: torch.Tensor, c: _Consts):
    """Limbs in [0, 2^33) -> (normalised limbs, carry out)."""
    lo = s & M32
    cin, cout = lookahead(s > M32, lo == M32, c)
    return (lo + cin) & M32, cout


def resolve_borrow(d: torch.Tensor, c: _Consts):
    """Limbs in [-2^32, 2^32) -> (normalised limbs, borrow out)."""
    lo = d & M32
    bin_, bout = lookahead(d < 0, lo == 0, c)
    return (lo - bin_) & M32, bout


def cond_sub_u64(x: torch.Tensor, c: _Consts) -> torch.Tensor:
    """x in [0, 2p) -> x mod p."""
    y, bout = resolve_borrow(x - _col(c.p, x.dim()), c)
    return torch.where((bout == 0).unsqueeze(0), y, x)


def add_u64(a: torch.Tensor, b: torch.Tensor, c: _Consts) -> torch.Tensor:
    s, _ = resolve_carry(a + b, c)  # a + b < 2p < 2^256: no carry out
    return cond_sub_u64(s, c)


def sub_u64(a: torch.Tensor, b: torch.Tensor, c: _Consts) -> torch.Tensor:
    d, bout = resolve_borrow(a - b, c)
    e, _ = resolve_carry(d + _col(c.p, d.dim()), c)  # a < b: a - b + p
    return torch.where((bout != 0).unsqueeze(0), e, d)


def neg_u64(a: torch.Tensor, c: _Consts) -> torch.Tensor:
    d, _ = resolve_borrow(_col(c.p, a.dim()) - a, c)
    return torch.where(is_zero(a).unsqueeze(0), a, d)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(0)


class U64Field:
    """Add, sub and the Montgomery product over int64 tensors holding one
    32-bit limb each, every op plain PyTorch: the arithmetic of the plain
    versions of the point and NTT kernels, which convert their int32
    inputs once and their outputs once."""

    def __init__(self, p: int, device):
        self.p = p
        self.c = consts(p, device)

    def add(self, a, b):
        return add_u64(a, b, self.c)

    def sub(self, a, b):
        return sub_u64(a, b, self.c)

    def mul(self, a, b):
        return _mm.mont_mul_u64(a, b, self.p)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane-wise a where mask else b; mask has the lane shape."""
    return torch.where(mask.unsqueeze(0), a, b)


class FieldKernels:
    """Batched kernels for one prime modulus p < 2^255 on one device.

    All element tensors have shape ``(8, ...)`` int32 with canonical 32-bit
    limbs in the Montgomery domain unless stated otherwise."""

    def __init__(self, p: int, device=None):
        assert p % 2 == 1 and p.bit_length() <= 255
        self.p = p
        self.device = resolve_device(device)
        self.R = (1 << (LIMBS * LIMB_BITS)) % p
        self.R2 = self.R * self.R % p
        self.c = consts(p, self.device)
        self._r2 = torch.from_numpy(ints_to_limbs_np([self.R2])).to(self.device)
        self._one_mont = torch.from_numpy(ints_to_limbs_np([self.R])).to(self.device)
        self._native_field = None
        e = p - 2
        self._inv_bits = [(e >> i) & 1 for i in range(e.bit_length())]

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------
    def _native(self):
        """The C++ host runtime for this modulus (bound on first use), or
        None where the library is absent."""
        if not native.available():
            return None
        if self._native_field is None:
            self._native_field = native.NativeField(self.p)
        return self._native_field

    def pack_np(self, xs: Sequence[int], mont: bool = True) -> np.ndarray:
        """python ints -> (8, N) numpy limb array: the C++ runtime's
        :meth:`..native.NativeField.pack_ints` where the library is built,
        else :meth:`pack_python` (the same values)."""
        nf = self._native()
        if nf is not None:
            return nf.pack_ints(xs, mont=mont)
        return self.pack_python(xs, mont)

    def pack_python(self, xs: Sequence[int], mont: bool = True) -> np.ndarray:
        """python ints -> (8, N) numpy limb array, the Montgomery conversion
        in Python ints: the plain version of the bridge."""
        p = self.p
        xs = [x % p * self.R % p for x in xs] if mont else [x % p for x in xs]
        return ints_to_limbs_np(xs)

    def pack_bytes(self, buf, mont: bool = True, lanes: int | None = None) -> torch.Tensor:
        """Canonical little-endian 32-byte values (each < p, as
        :func:`..native.ints_to_bytes` and the C++ sparse product make
        them: K2 takes no other input), as ``bytes`` or a uint8 host tensor
        (:func:`bytes_to_limbs`) -> (8, lanes) limb tensor on this
        device, zero padded (:func:`bytes_to_limbs`), then into the
        Montgomery domain by :meth:`to_mont` (one K2 launch on the card)
        when ``mont``."""
        x = bytes_to_limbs(buf, self.device, lanes)
        return self.to_mont(x) if mont else x

    def pack(self, xs: Sequence[int], mont: bool = True) -> torch.Tensor:
        """python ints -> (8, N) limb tensor on this device (Montgomery by
        default): each x mod p as bytes, then :meth:`pack_bytes`."""
        return self.pack_bytes(native.ints_to_bytes(xs, self.p), mont)

    def unpack(self, arr: torch.Tensor, mont: bool = True) -> List[int]:
        """(8, N) limb tensor -> python ints (out of Montgomery domain: one
        product by 1 on the device, then a byte decode on the host)."""
        if mont:
            arr = self.from_mont(arr.contiguous())
        return limbs_np_to_ints(arr.cpu().numpy())

    # ------------------------------------------------------------------
    # arithmetic (plain PyTorch, except the product)
    # ------------------------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return from_u64(add_u64(to_u64(a), to_u64(b), self.c))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return from_u64(sub_u64(to_u64(a), to_u64(b), self.c))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return from_u64(neg_u64(to_u64(a), self.c))

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b*R^-1 mod p: kernel K2 on a CUDA tensor,
        its plain version on a CPU tensor."""
        return _mm.mont_mul(a, b, self.p)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_const(self, a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """a * k where k is a single element ((8,) or (8, 1) limbs)."""
        k = k.reshape((LIMBS,) + (1,) * (a.dim() - 1))
        return self.mul(a, k.expand(a.shape).contiguous())

    # ------------------------------------------------------------------
    # domain conversion / predicates / constants
    # ------------------------------------------------------------------
    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        return self.mul_const(x, self._r2)

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        one = torch.zeros_like(x)
        one[0] = 1
        return self.mul(x, one)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return is_zero(a)

    def equal(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(0)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return select(mask, a, b)

    def zeros_like(self, a: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(a)

    def zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((LIMBS, n), dtype=torch.int32, device=self.device)

    def ones_mont(self, n: int) -> torch.Tensor:
        return self._one_mont.expand(LIMBS, n).contiguous()

    # ------------------------------------------------------------------
    # inversion (Fermat) — used for batched affine conversion on-device
    # ------------------------------------------------------------------
    def batch_inverse(self, a: torch.Tensor) -> torch.Tensor:
        """Tree-structured batched inversion: ~3N Montgomery products
        (product tree up, one Fermat inversion of the root, unwind down).
        Zero inputs invert to zero."""
        n = a.shape[1]
        zero_mask = self.is_zero(a)
        x = torch.where(zero_mask.unsqueeze(0), self.ones_mont(n), a)
        # pad lanes to a power of two with Montgomery ones
        n2 = 1 << (n - 1).bit_length()
        if n2 != n:
            x = torch.cat([x, self.ones_mont(n2 - n)], dim=1)
        levels = []
        cur = x
        while cur.shape[1] > 1:
            h = cur.shape[1] // 2
            pair = cur.reshape(LIMBS, h, 2)
            lo, hi = pair[:, :, 0].contiguous(), pair[:, :, 1].contiguous()
            levels.append((lo, hi))
            cur = self.mul(lo, hi)
        inv = self.inverse(cur)  # (8, 1) Fermat on the root
        for lo, hi in reversed(levels):
            inv_lo = self.mul(inv, hi)
            inv_hi = self.mul(inv, lo)
            h = inv_lo.shape[1]
            inv = torch.stack([inv_lo, inv_hi], dim=2).reshape(LIMBS, 2 * h)
        inv = inv[:, :n]
        return torch.where(zero_mask.unsqueeze(0), torch.zeros_like(inv), inv)

    def inverse(self, a: torch.Tensor) -> torch.Tensor:
        """a^(p-2) (Fermat): square-and-multiply over the exponent's bits,
        LSB first.  The JAX version multiplies on every bit and selects;
        skipping the products for zero bits gives the same value."""
        acc = self.ones_mont(a.shape[1])
        base = a.contiguous()
        for i, bit in enumerate(self._inv_bits):
            if bit:
                acc = self.mul(acc, base)
            if i + 1 < len(self._inv_bits):
                base = self.mul(base, base)
        return acc
