"""Batched, branchless Jacobian point arithmetic.

Mirrors ``go_snark_study_tpu/ops/curve_ops.py``: the same EFD formulas
(add-2007-bl / madd-2007-bl / dbl-2009-l) vectorised over N points, with
all control flow turned into lane masks:

  * identity handling: Z == 0 selects the other operand;
  * equal-point handling: the affine-equal case (h == 0, s1 == s2) routes to
    the doubling result;
  * inverse-point case (h == 0, s1 != s2) yields the identity.

Field elements are (8, ...) limb tensors (:mod:`.limbs`); G2 runs the
identical formulas over a batched Fq2 adapter (Karatsuba mul, beta = -1).
The formulas take the field adapter ``F`` as an argument, so the same code
runs over :class:`.limbs.FieldKernels` (products on K2) and over the plain
:class:`.limbs.U64Field` (inside the plain version of K1).

Whole-point adds (``madd``/``jadd`` and their flagged incomplete forms,
``madd_flagged``/``jadd_flagged``) on a :class:`G1Batch`/:class:`G2Batch`
go to K1 (:mod:`.point_add`) for every lane count; the JAX package's
``lanes < 256`` escape to XLA is not copied.
"""

from __future__ import annotations

import torch

from . import point_add as _pa
from .limbs import FieldKernels

__all__ = [
    "AFFINE_TILE",
    "BatchFq",
    "BatchFq2",
    "jacobian_add",
    "jacobian_add_mixed",
    "jacobian_add_incomplete",
    "jacobian_add_mixed_incomplete",
    "jacobian_double",
    "G1Batch",
    "G2Batch",
    "tree_map",
]


# to_affine_tiled's default tile: one inversion tree holds at most 2^20
# lanes (~64 MB of Fq elements in its levels)
AFFINE_TILE = 1 << 20


def tree_map(fn, *trees):
    """Map over nested tuples of tensors (the point pytrees)."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


class BatchFq:
    """Adapter presenting a field (FieldKernels, or the plain U64Field) as
    the generic field interface the Jacobian formulas consume."""

    def __init__(self, K):
        self.K = K

    def add(self, a, b):
        return self.K.add(a, b)

    def sub(self, a, b):
        return self.K.sub(a, b)

    def mul(self, a, b):
        return self.K.mul(a, b)

    def square(self, a):
        return self.K.mul(a, a)

    def double(self, a):
        return self.K.add(a, a)

    def is_zero(self, a):
        return self.K.is_zero(a)

    def equal(self, a, b):
        return self.K.equal(a, b)

    def select(self, mask, a, b):
        """mask: (...) bool; picks a where true."""
        return self.K.select(mask, a, b)

    def zeros_like(self, a):
        return self.K.zeros_like(a)

    def neg(self, a):
        return self.K.neg(a)

    def inverse(self, a):
        """Batched tree inversion (zero -> zero)."""
        return self.K.batch_inverse(a)

    def one(self, n: int):
        return self.K.ones_mont(n)


class BatchFq2:
    """Batched Fq2 with beta = -1 (BN128's non-residue: bn128.go:86).
    Elements: pairs (c0, c1) of (8, ...) tensors."""

    def __init__(self, K):
        self.K = K

    def add(self, a, b):
        return (self.K.add(a[0], b[0]), self.K.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.K.sub(a[0], b[0]), self.K.sub(a[1], b[1]))

    def mul(self, a, b):
        K = self.K
        v0 = K.mul(a[0], b[0])
        v1 = K.mul(a[1], b[1])
        t = K.mul(K.add(a[0], a[1]), K.add(b[0], b[1]))
        return (
            K.sub(v0, v1),  # beta = -1
            K.sub(t, K.add(v0, v1)),
        )

    def square(self, a):
        # complex squaring for beta=-1: (a0^2 - a1^2, 2 a0 a1)
        K = self.K
        t = K.mul(K.add(a[0], a[1]), K.sub(a[0], a[1]))
        m = K.mul(a[0], a[1])
        return (t, K.add(m, m))

    def double(self, a):
        return (self.K.add(a[0], a[0]), self.K.add(a[1], a[1]))

    def is_zero(self, a):
        return torch.logical_and(self.K.is_zero(a[0]), self.K.is_zero(a[1]))

    def equal(self, a, b):
        return torch.logical_and(self.K.equal(a[0], b[0]), self.K.equal(a[1], b[1]))

    def select(self, mask, a, b):
        return (self.K.select(mask, a[0], b[0]), self.K.select(mask, a[1], b[1]))

    def zeros_like(self, a):
        return (self.K.zeros_like(a[0]), self.K.zeros_like(a[1]))

    def neg(self, a):
        return (self.K.neg(a[0]), self.K.neg(a[1]))

    def inverse(self, a):
        """(a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2) for beta = -1
        (eprint 2010/354 alg 8, batched; zero -> zero)."""
        K = self.K
        norm = K.add(K.mul(a[0], a[0]), K.mul(a[1], a[1]))
        ninv = K.batch_inverse(norm)
        return (K.mul(a[0], ninv), K.neg(K.mul(a[1], ninv)))

    def one(self, n: int):
        return (self.K.ones_mont(n), self.K.zeros(n))


def jacobian_double(F, p):
    """dbl-2009-l, branchless (identity doubles to identity for free since
    Z=0 gives Z3 = 2*Y*Z = 0)."""
    x, y, z = p
    a = F.square(x)
    b = F.square(y)
    c = F.square(b)
    t = F.square(F.add(x, b))
    d = F.double(F.sub(F.sub(t, a), c))
    e = F.add(F.double(a), a)
    f = F.square(e)
    x3 = F.sub(f, F.double(d))
    c8 = F.double(F.double(F.double(c)))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    z3 = F.double(F.mul(y, z))
    return (x3, y3, z3)


def _sel(F, m, a, b):
    return tuple(F.select(m, ca, cb) for ca, cb in zip(a, b))


def jacobian_add(F, p1, p2):
    """add-2007-bl with full case analysis via masks."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    p1_zero = F.is_zero(z1)
    p2_zero = F.is_zero(z2)

    z1z1 = F.square(z1)
    z2z2 = F.square(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(y1, F.mul(z2, z2z2))
    s2 = F.mul(y2, F.mul(z1, z1z1))
    h = F.sub(u2, u1)
    r_ = F.double(F.sub(s2, s1))

    h_zero = F.is_zero(h)
    r_zero = F.is_zero(r_)

    i = F.square(F.double(h))
    j = F.mul(h, i)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.square(r_), j), F.double(v))
    y3 = F.sub(F.mul(r_, F.sub(v, x3)), F.double(F.mul(s1, j)))
    z3 = F.mul(F.sub(F.sub(F.square(F.add(z1, z2)), z1z1), z2z2), h)
    added = (x3, y3, z3)

    doubled = jacobian_double(F, p1)

    # case selection (order matters: identity cases first)
    same_x_same_y = torch.logical_and(h_zero, r_zero)
    same_x_diff_y = torch.logical_and(h_zero, torch.logical_not(r_zero))
    zero_pt = tuple(F.zeros_like(c) for c in added)

    out = _sel(F, same_x_same_y, doubled, added)  # p1 == p2 -> double
    out = _sel(F, same_x_diff_y, zero_pt, out)  # p1 == -p2 -> infinity
    out = _sel(F, p2_zero, p1, out)
    out = _sel(F, p1_zero, p2, out)
    return out


def jacobian_add_mixed(F, p1, p2):
    """madd-2007-bl: p1 Jacobian + p2 AFFINE (z2 must be the field one for
    live points, zero for identity padding).  7M+4S vs the full add's
    11M+5S — the workhorse of the MSM accumulation phase."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    p1_zero = F.is_zero(z1)
    p2_zero = F.is_zero(z2)

    z1z1 = F.square(z1)
    u2 = F.mul(x2, z1z1)
    s2 = F.mul(y2, F.mul(z1, z1z1))
    h = F.sub(u2, x1)
    r_ = F.double(F.sub(s2, y1))
    h_zero = F.is_zero(h)
    r_zero = F.is_zero(r_)

    hh = F.square(h)
    i = F.double(F.double(hh))
    j = F.mul(h, i)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.square(r_), j), F.double(v))
    y3 = F.sub(F.mul(r_, F.sub(v, x3)), F.double(F.mul(y1, j)))
    z3 = F.sub(F.sub(F.square(F.add(z1, h)), z1z1), hh)
    added = (x3, y3, z3)

    doubled = jacobian_double(F, p1)

    same_x_same_y = torch.logical_and(h_zero, r_zero)
    same_x_diff_y = torch.logical_and(h_zero, torch.logical_not(r_zero))
    zero_pt = tuple(F.zeros_like(c) for c in added)

    out = _sel(F, same_x_same_y, doubled, added)
    out = _sel(F, same_x_diff_y, zero_pt, out)
    out = _sel(F, p2_zero, p1, out)
    out = _sel(F, p1_zero, p2, out)
    return out


def jacobian_add_incomplete(F, p1, p2):
    """add-2007-bl WITHOUT the doubling branch (11M+5S).  Returns
    ``(point, bad)`` where ``bad`` marks lanes that hit the degenerate case
    h == 0 with both operands live (equal or inverse points) — there the
    emitted point is WRONG, so callers OR the (suitably masked) flags and
    re-run through the complete formulas when any fires.  Identity operands
    are still handled branchlessly."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    p1_zero = F.is_zero(z1)
    p2_zero = F.is_zero(z2)

    z1z1 = F.square(z1)
    z2z2 = F.square(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(y1, F.mul(z2, z2z2))
    s2 = F.mul(y2, F.mul(z1, z1z1))
    h = F.sub(u2, u1)
    r_ = F.double(F.sub(s2, s1))
    h_zero = F.is_zero(h)

    i = F.square(F.double(h))
    j = F.mul(h, i)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.square(r_), j), F.double(v))
    y3 = F.sub(F.mul(r_, F.sub(v, x3)), F.double(F.mul(s1, j)))
    z3 = F.mul(F.sub(F.sub(F.square(F.add(z1, z2)), z1z1), z2z2), h)

    out = _sel(F, p2_zero, p1, (x3, y3, z3))
    out = _sel(F, p1_zero, p2, out)
    live = torch.logical_not(torch.logical_or(p1_zero, p2_zero))
    return out, torch.logical_and(h_zero, live)


def jacobian_add_mixed_incomplete(F, p1, p2):
    """madd-2007-bl without the doubling branch: 7M+4S.  Same flag contract
    as :func:`jacobian_add_incomplete`."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    p1_zero = F.is_zero(z1)
    p2_zero = F.is_zero(z2)

    z1z1 = F.square(z1)
    u2 = F.mul(x2, z1z1)
    s2 = F.mul(y2, F.mul(z1, z1z1))
    h = F.sub(u2, x1)
    r_ = F.double(F.sub(s2, y1))
    h_zero = F.is_zero(h)

    hh = F.square(h)
    i = F.double(F.double(hh))
    j = F.mul(h, i)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.square(r_), j), F.double(v))
    y3 = F.sub(F.mul(r_, F.sub(v, x3)), F.double(F.mul(y1, j)))
    z3 = F.sub(F.sub(F.square(F.add(z1, h)), z1z1), hh)

    out = _sel(F, p2_zero, p1, (x3, y3, z3))
    out = _sel(F, p1_zero, p2, out)
    live = torch.logical_not(torch.logical_or(p1_zero, p2_zero))
    return out, torch.logical_and(h_zero, live)


class _BatchGroup:
    def __init__(self, F, K: FieldKernels, coord_arity: int):
        self.F = F
        self.K = K
        self._arity = coord_arity

    # -- whole-point add: kernel K1 (the MSM's adds are K1's MSM forms,
    # :mod:`.msm_kernels`) ------------------------------------------------
    def madd(self, p1, p2):
        """Mixed add p1 (Jacobian) + p2 (affine, z in {0, 1})."""
        return _pa.point_add("madd", self._arity, p1, p2)

    def jadd(self, p1, p2):
        """Full Jacobian add."""
        return _pa.point_add("jadd", self._arity, p1, p2)

    def madd_flagged(self, p1, p2):
        """Incomplete mixed add: ``(p1 + p2, degenerate_mask)``, the mask
        of the lane shape."""
        return _pa.point_add("madd_f", self._arity, p1, p2)

    def jadd_flagged(self, p1, p2):
        """Incomplete full Jacobian add: ``(p1 + p2, degenerate_mask)``."""
        return _pa.point_add("jadd_f", self._arity, p1, p2)

    def neg_y_where(self, p, mask):
        """y -> -y on the lanes where ``mask`` holds (identity lanes stay
        identity, since -0 = 0): the signed-digit MSM folds a digit's sign
        into its point."""
        from .msm_kernels import neg_y_where  # msm_kernels imports this module

        return neg_y_where(p, mask, self._arity)

    def double(self, p):
        return jacobian_double(self.F, p)

    def is_zero(self, p):
        return self.F.is_zero(p[2])

    def to_affine(self, p):
        """Jacobian -> affine (x/z^2, y/z^3, 1) batched; identities map to
        (0, 0, 0).  ~7 products per point via the tree batch inversion —
        run once per proving key so every MSM accumulation add is the cheap
        mixed add.  One inversion tree over all lanes (padded to a power of
        two); :meth:`to_affine_tiled` bounds the tree's width."""
        F = self.F
        x, y, z = p
        is_id = F.is_zero(z)
        zinv = F.inverse(z)
        zi2 = F.square(zinv)
        zi3 = F.mul(zi2, zinv)
        ax = F.mul(x, zi2)
        ay = F.mul(y, zi3)
        one = self.one_coord(z)
        zero = F.zeros_like(z)
        nz = torch.logical_not(is_id)
        return (
            F.select(nz, ax, zero),
            F.select(nz, ay, zero),
            F.select(nz, one, zero),
        )

    def to_affine_tiled(self, p, tile: int | None = None):
        """:meth:`to_affine` in slices of ``tile`` lanes (default
        ``AFFINE_TILE``), one inversion tree each, so that the tree's memory
        is bounded whatever the lane count.  Lanes are independent, so the
        values are :meth:`to_affine`'s bit for bit, identity lanes included.
        The JAX package pads the last tile to a fixed compiled width; the
        port leaves it ragged."""
        tile = tile or AFFINE_TILE
        n = tree_leaves(p)[0].shape[-1]
        if n <= tile:
            return self.to_affine(p)
        parts = [self.to_affine(tree_map(lambda c: c[:, i : i + tile].contiguous(), p)) for i in range(0, n, tile)]
        return tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)

    def one_coord(self, like):
        """Field one broadcast to the lane count of ``like``."""
        n = like.shape[1] if not isinstance(like, tuple) else like[0].shape[1]
        return self.F.one(n)


class G1Batch(_BatchGroup):
    """Batched G1.  Host bridge: points are reference-style Jacobian int
    triples (curve.py); device layout is ((8,N),)*3 Montgomery limbs."""

    def __init__(self, K: FieldKernels):
        super().__init__(BatchFq(K), K, 1)

    def pack(self, points):
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        zs = [p[2] for p in points]
        return (self.K.pack(xs), self.K.pack(ys), self.K.pack(zs))

    def unpack(self, p):
        xs = self.K.unpack(p[0])
        ys = self.K.unpack(p[1])
        zs = self.K.unpack(p[2])
        return list(zip(xs, ys, zs))

    def zeros(self, n: int):
        z = self.K.zeros(n)
        return (z, z, z)


class G2Batch(_BatchGroup):
    """Batched G2 over Fq2.  Device layout: 3 coords x 2 components."""

    def __init__(self, K: FieldKernels):
        super().__init__(BatchFq2(K), K, 2)

    def pack(self, points):
        def comp(ci, cj):
            return self.K.pack([p[ci][cj] for p in points])

        return (
            (comp(0, 0), comp(0, 1)),
            (comp(1, 0), comp(1, 1)),
            (comp(2, 0), comp(2, 1)),
        )

    def unpack(self, p):
        c = [[self.K.unpack(p[i][j]) for j in range(2)] for i in range(3)]
        n = len(c[0][0])
        return [
            ((c[0][0][k], c[0][1][k]), (c[1][0][k], c[1][1][k]), (c[2][0][k], c[2][1][k]))
            for k in range(n)
        ]

    def zeros(self, n: int):
        z = self.K.zeros(n)
        return ((z, z), (z, z), (z, z))
