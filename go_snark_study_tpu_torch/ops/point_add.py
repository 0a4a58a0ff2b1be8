"""K1: one Jacobian point add per lane, every intermediate on chip.

Replaces ``go_snark_study_tpu/ops/pallas_curve.py::_point_kernel``
(:162-192, built by ``make_pallas_point_op`` :203-260, with the field
adapters ``_RowField`` :39-117 and ``_RowField2`` :120-159).  The kernel is
``csrc/point_add.cu``: eight template instances, {mixed, full} ×
{complete, incomplete+flag} × {G1 over Fq, G2 over Fq2}, the same formulas
as :mod:`.curve_ops` written over the header's Fp/Fp2 arithmetic.  The
flagged (incomplete) forms also write an int32 flag per lane: h = 0 with
both operands live.  The complete forms evaluate the doubling only on the
lanes that need it.

What bounds it on the H100: operations.  A G1 incomplete mixed add reads
6×32 bytes, writes 3×32 + 4, and does 11 Montgomery products (≈ 2,900
IMADs) per lane; G2 triples the products and doubles the bytes.  A G1
lane is one thread and a G2 lane a pair of threads (one Fq2 component
each, ``Fp2S`` in ``csrc/field.cuh``), so a point's intermediates stay in
registers without spilling, as the TPU kernel kept them in VMEM; the cost
left is the multiply count.  On the 2^16 path this per-lane kernel runs
the setup's fixed-base commits; the MSM's adds are K1's MSM forms
(:mod:`.msm_kernels`).

Beside the kernel: :func:`point_add_plain`, the plain PyTorch version
(the :mod:`.curve_ops` formulas over the plain ``U64Field``), and the
launch count ``POINT_ADD.launches`` (all instances together; the
per-instance counts are in ``INSTANCE_LAUNCHES``).  On a CUDA tensor
:func:`point_add` launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..bn128 import constants as C
from .mont_mul import check_limbs

__all__ = ["POINT_ADD", "FORMS", "point_add", "point_add_plain"]

# form name -> (index in csrc/point_add.cu, curve_ops formula, flagged)
FORMS = {
    "madd": (0, "jacobian_add_mixed", False),
    "jadd": (1, "jacobian_add", False),
    "madd_f": (2, "jacobian_add_mixed_incomplete", True),
    "jadd_f": (3, "jacobian_add_incomplete", True),
}

POINT_ADD = _build.Kernel(
    "K1 point_add",
    "point_add",
    "gs_point_add",
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "go_snark_study_tpu/ops/pallas_curve.py:162",
)
INSTANCE_LAUNCHES = {(f, a): 0 for f in FORMS for a in (1, 2)}


def _leaves(p, arity: int):
    if arity == 1:
        return list(p)
    return [comp for coord in p for comp in coord]


def _unleaves(cs, arity: int):
    if arity == 1:
        return tuple(cs)
    return tuple((cs[2 * i], cs[2 * i + 1]) for i in range(3))


def point_add(form: str, arity: int, p1, p2):
    """p1 + p2 over G1 (arity 1) or G2 (arity 2).  Points are pytrees of
    (8, ...) int32 limb tensors, all of one shape.  Returns the point, and
    for the flagged forms ``(point, bad)`` with ``bad`` a bool tensor of
    the lane shape."""
    idx, _, flagged = FORMS[form]
    c1, c2 = _leaves(p1, arity), _leaves(p2, arity)
    for k, t in enumerate(c1 + c2):
        check_limbs(f"coordinate {k}", t, like=c1[0])
    if c1[0].device.type == "cpu":
        return point_add_plain(form, arity, p1, p2)
    out = [torch.empty_like(c1[0]) for _ in c1]
    lane_shape = c1[0].shape[1:]
    flag = torch.empty(lane_shape, dtype=torch.int32, device=c1[0].device)
    n = c1[0].numel() // 8
    if n:
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
        a1, a2, ao = ptrs(c1), ptrs(c2), ptrs(out)
        POINT_ADD.launch(
            idx, arity,
            ctypes.cast(a1, ctypes.c_void_p), ctypes.cast(a2, ctypes.c_void_p),
            ctypes.cast(ao, ctypes.c_void_p),
            flag.data_ptr() if flagged else None, n, _build.stream_ptr(c1[0]),
        )
        INSTANCE_LAUNCHES[(form, arity)] += 1
    pt = _unleaves(out, arity)
    return (pt, flag != 0) if flagged else pt


class _Node:
    """A field value the formula has asked for but not computed yet."""

    __slots__ = ("op", "args", "val")

    def __init__(self, op, args=(), val=None):
        self.op, self.args, self.val = op, args, val


class _LevelField:
    """The :class:`.limbs.U64Field` interface, evaluated lazily: add, sub,
    mul and select only record a node; a mask query (``is_zero``) or the
    end of the formula evaluates every recorded node, one dependency level
    at a time, with all the nodes of one op and level stacked into a single
    tensor op.  The values are exactly those of eager evaluation; a G2 add
    then costs about as many tensor ops as a G1 add."""

    def __init__(self, K):
        self.K = K
        self.pending = []

    def _rec(self, op, *args):
        node = _Node(op, args)
        self.pending.append(node)
        return node

    def leaf(self, t: torch.Tensor) -> _Node:
        return _Node("leaf", val=t)

    def add(self, a, b):
        return self._rec("add", a, b)

    def sub(self, a, b):
        return self._rec("sub", a, b)

    def mul(self, a, b):
        return self._rec("mul", a, b)

    def select(self, mask, a, b):
        return self._rec("select", mask, a, b)

    def zeros_like(self, a):
        self.force()
        return self.leaf(torch.zeros_like(a.val))

    def is_zero(self, a):
        self.force()
        return (a.val == 0).all(0)

    def force(self):
        """Evaluate every pending node, level by level."""
        level = {}
        for node in self.pending:  # recorded in dependency order
            level[node] = 1 + max(
                (level.get(a, 0) for a in node.args if isinstance(a, _Node)), default=0
            )
        by_level = {}
        for node in self.pending:
            by_level.setdefault((level[node], node.op), []).append(node)
        for (_, op), nodes in sorted(by_level.items(), key=lambda kv: kv[0][0]):
            if op == "select":
                mask = torch.stack([n.args[0] for n in nodes]).unsqueeze(0)
                a = torch.stack([n.args[1].val for n in nodes], dim=1)
                b = torch.stack([n.args[2].val for n in nodes], dim=1)
                out = torch.where(mask, a, b)
            else:
                a = torch.stack([n.args[0].val for n in nodes], dim=1)
                b = torch.stack([n.args[1].val for n in nodes], dim=1)
                out = getattr(self.K, op)(a, b)
            for i, n in enumerate(nodes):
                n.val = out[:, i]
        self.pending = []


def point_add_plain(form: str, arity: int, p1, p2):
    """Plain PyTorch version of K1: the :mod:`.curve_ops` formula over the
    plain field on int64 copies of the limbs (any device), evaluated one
    dependency level at a time."""
    from . import curve_ops as co
    from .limbs import U64Field, from_u64, to_u64

    _, name, flagged = FORMS[form]
    dev = _leaves(p1, arity)[0].device
    L = _LevelField(U64Field(C.Q, dev))
    F = co.BatchFq(L) if arity == 1 else co.BatchFq2(L)
    leaf = lambda t: L.leaf(to_u64(t))
    res = getattr(co, name)(F, co.tree_map(leaf, p1), co.tree_map(leaf, p2))
    pt, bad = res if flagged else (res, None)
    L.force()
    pt = co.tree_map(lambda n: from_u64(n.val), pt)
    return (pt, bad) if flagged else pt
