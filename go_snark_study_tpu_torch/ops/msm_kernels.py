"""K1's MSM forms: the Pippenger MSM's serial loops as kernels.

The JAX package writes the tiled accumulation, the segmented merge scan and
the bucket reduction of ``go_snark_study_tpu/ops/msm.py`` as ``jax.lax.scan``
/ ``fori_loop`` loops over its point kernel
(``ops/pallas_curve.py::_point_kernel``); on the TPU each loop is one
compiled program.  Here each loop is a launch of ``csrc/msm_scan.cu`` in
which every thread owns one lane (a pair of threads for G2) across all the
loop's steps:

  * :func:`apply`: the K-step tiled accumulation over a sort plan, sign
    folding and compaction included (one launch per window group);
  * :func:`seg_scan`: the segmented Hillis-Steele merge (one launch per
    step, ping-pong buffers);
  * :func:`reduce`: the bucket reduction (two launches: W·Q lanes over the
    D buckets of a chunk, then W lanes over the Q chunks, the doublings and
    the final add).

Each form has four instances: G1 or G2, incomplete adds with the
degeneracy flag or the complete adds of the re-run engine.  The adds are
the same, in the same order, as the loops of the plain versions
(:func:`apply_plain`, :func:`seg_scan_plain`, :func:`reduce_plain`, which
are the JAX package's loops over the plain K1), so the results are bit for
bit those of the JAX engine, and a flag fires on the same inputs.  A
kernel folds its flags into one int32 on the device.

What bounds the forms on the H100 is in the source note of
``csrc/msm_scan.cu``.  On a CUDA tensor a wrapper launches its kernel or
raises; only a CPU tensor takes the plain version.  ``APPLY.launches``,
``SEG_SCAN.launches`` and ``REDUCE.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..bn128 import constants as C
from . import point_add as pa
from .curve_ops import BatchFq, BatchFq2, jacobian_double, tree_map
from .limbs import LIMBS, U64Field, consts, from_u64, neg_u64, to_u64
from .mont_mul import check_limbs

__all__ = [
    "APPLY",
    "SEG_SCAN",
    "REDUCE",
    "apply",
    "apply_plain",
    "seg_scan",
    "seg_scan_plain",
    "reduce",
    "reduce_plain",
    "neg_y_where",
]

_REPLACES = "go_snark_study_tpu/ops/pallas_curve.py:243"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

APPLY = _build.Kernel(
    "K1 msm_apply", "msm_scan", "gs_msm_apply",
    [_I, _I, _P, _LL, _P, _P, _P, _P, _I, _LL, _LL, _LL, _P, _LL, _P, _P],
    _REPLACES,
)
SEG_SCAN = _build.Kernel(
    "K1 msm_seg_scan", "msm_scan", "gs_msm_seg_step",
    [_I, _I, _P, _P, _P, _LL, _LL, _LL, _P, _P],
    _REPLACES,
)
REDUCE = _build.Kernel(
    "K1 msm_reduce", "msm_scan", "gs_msm_reduce",
    [_I, _I, _I, _P, _P, _LL, _I, _I, _P, _P, _P, _P],
    _REPLACES,
)


# ---------------------------------------------------------------------------
# argument checks and launch helpers
# ---------------------------------------------------------------------------
def _check_points(pts, arity: int, name: str):
    leaves = pa._leaves(pts, arity)
    if len(leaves) != 3 * arity:
        raise ValueError(f"{name}: expected {3 * arity} coordinate tensors, got {len(leaves)}")
    for k, t in enumerate(leaves):
        check_limbs(f"{name} coordinate {k}", t, like=leaves[0])
    return leaves


def _check_index(name: str, t: torch.Tensor, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _ptrs(ts):
    arr = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    return ctypes.cast(arr, ctypes.c_void_p), arr  # keep arr alive for the call


def _zeros_point(n: int, arity: int, device):
    z = torch.zeros((LIMBS, n), dtype=torch.int32, device=device)
    return (z, z, z) if arity == 1 else ((z, z), (z, z), (z, z))


def neg_y_where(p, mask, arity: int):
    """y -> -y (0 stays 0) on the lanes where ``mask`` holds: the signed-digit
    MSM folds a digit's sign into its point (plain PyTorch, any device)."""
    c = consts(C.Q, mask.device)
    neg = lambda t: torch.where(mask.unsqueeze(0), from_u64(neg_u64(to_u64(t), c)), t)
    x, y, z = p
    return (x, neg(y) if arity == 1 else (neg(y[0]), neg(y[1])), z)


def _add_plain(form: str, arity: int, complete: bool, a, b):
    """One whole-point add of the plain K1: (point, any flag)."""
    if complete:
        return pa.point_add_plain(form, arity, a, b), None
    pt, bad = pa.point_add_plain(form + "_f", arity, a, b)
    return pt, bad


def _false(device):
    return torch.zeros((), dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# apply: the tiled accumulation over a sort plan, with compaction
# ---------------------------------------------------------------------------
def apply(points, plan: dict, arity: int, complete: bool):
    """Affine points (N lanes, z in {0, 1}) and one window group's sort plan
    (``ord3``, ``mag3``, ``neg3``, ``idx3`` of shape (K, Wg, m), and
    ``comp_dig`` of shape (Wg, p_cap)) -> (compacted run partials with
    leaves (8, Wg, p_cap), bad flag)."""
    leaves = _check_points(points, arity, "points")
    ord3, mag3, neg3, idx3 = plan["ord3"], plan["mag3"], plan["neg3"], plan["idx3"]
    dev = leaves[0].device
    if ord3.dim() != 3:
        raise ValueError(f"ord3: expected (K, Wg, m), got {tuple(ord3.shape)}")
    for name, t, dtype in (("ord3", ord3, torch.int64), ("mag3", mag3, torch.int32),
                           ("neg3", neg3, torch.bool), ("idx3", idx3, torch.int64)):
        _check_index(name, t, dtype, ord3.shape, dev)
    if dev.type == "cpu":
        return apply_plain(points, plan, arity, complete)
    k, wg, m = ord3.shape
    p_cap = plan["comp_dig"].shape[1]
    out = [torch.zeros((LIMBS, wg, p_cap), dtype=torch.int32, device=dev) for _ in leaves]
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    pin, _a = _ptrs(leaves)
    pout, _b = _ptrs(out)
    APPLY.launch(
        arity, int(complete), pin, leaves[0].shape[1], ord3.data_ptr(), mag3.data_ptr(),
        neg3.data_ptr(), idx3.data_ptr(), k, wg * m, m, p_cap, pout, wg * p_cap,
        flag.data_ptr(), _build.stream_ptr(leaves[0]),
    )
    return pa._unleaves(out, arity), flag != 0


def apply_plain(points, plan: dict, arity: int, complete: bool):
    """Plain PyTorch version of :func:`apply`: the JAX engine's K-step loop
    (``_apply_impl``) of wide mixed adds over the plain K1, then the
    compaction scatter (any device)."""
    ord3, mag3, neg3 = plan["ord3"], plan["mag3"], plan["neg3"]
    k, wg, m = ord3.shape
    dev = ord3.device
    acc = _zeros_point(wg * m, arity, dev)
    prev_mag = torch.full((wg * m,), -9, dtype=torch.int32, device=dev)
    bad = _false(dev)
    accs = []
    for j in range(k):
        fid = ord3[j].reshape(-1)
        pt = tree_map(lambda c_: c_.index_select(1, fid), points)
        pt = neg_y_where(pt, neg3[j].reshape(-1), arity)
        mflat = mag3[j].reshape(-1)
        boundary = mflat != prev_mag
        added, badm = _add_plain("madd", arity, complete, acc, pt)
        if badm is not None:
            # only flags whose result is consumed count: run interiors of
            # live (nonzero-magnitude) buckets
            bad = bad | (badm & ~boundary & (mflat > 0)).any()
        acc = tree_map(lambda p_, a_: torch.where(boundary.unsqueeze(0), p_, a_), pt, added)
        prev_mag = mflat
        accs.append(acc)

    idx3 = plan["idx3"]
    p_cap = plan["comp_dig"].shape[1]
    widx = torch.arange(wg, device=dev).view(1, wg, 1).expand_as(idx3)

    def compact(*cs):
        src = torch.stack(cs, 1).reshape(LIMBS, k, wg, m)  # (8, K, Wg, m)
        out = torch.zeros((LIMBS, wg, p_cap + 1), dtype=src.dtype, device=src.device)
        out[:, widx, idx3] = src
        return out[:, :, :p_cap].contiguous()

    return tree_map(compact, *accs), bad


# ---------------------------------------------------------------------------
# seg_scan: the segmented Hillis-Steele merge of equal-digit runs
# ---------------------------------------------------------------------------
def seg_scan(pts, sdig: torch.Tensor, arity: int, complete: bool):
    """Inclusive scan over contiguous runs of equal ``sdig`` along the last
    axis: point leaves (8, ..., P), ``sdig`` (..., P) int32; negative digits
    are sentinels.  Returns (scanned points, bad flag)."""
    leaves = _check_points(pts, arity, "pts")
    dev = leaves[0].device
    _check_index("sdig", sdig, torch.int32, leaves[0].shape[1:], dev)
    if dev.type == "cpu":
        return seg_scan_plain(pts, sdig, arity, complete)
    P, n = sdig.shape[-1], sdig.numel()
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    cur = leaves
    if n:
        for s in range(max(1, (P - 1).bit_length())):
            nxt = [torch.empty_like(t) for t in cur]
            pin, _a = _ptrs(cur)
            pout, _b = _ptrs(nxt)
            SEG_SCAN.launch(
                arity, int(complete), pin, pout, sdig.data_ptr(), P, n, 1 << s,
                flag.data_ptr(), _build.stream_ptr(sdig),
            )
            cur = nxt
    return pa._unleaves(cur, arity), flag != 0


def seg_scan_plain(pts, sdig: torch.Tensor, arity: int, complete: bool):
    """Plain PyTorch version of :func:`seg_scan`: the JAX engine's
    ``_seg_scan_runs`` over the plain K1 (any device)."""
    P = sdig.shape[-1]
    lane = torch.arange(P, device=sdig.device).expand_as(sdig)
    live = sdig > 0  # bucket-0 / sentinel results are discarded
    acc, bad = pts, _false(sdig.device)
    for s in range(max(1, (P - 1).bit_length())):
        d = 1 << s
        same = torch.logical_and(lane >= d, torch.roll(sdig, d, dims=-1) == sdig)
        prev = tree_map(lambda c_: torch.roll(c_, d, dims=-1), acc)
        summed, badm = _add_plain("jadd", arity, complete, acc, prev)
        if badm is not None:
            bad = bad | (badm & same & live).any()
        acc = tree_map(lambda s_, a_: torch.where(same.unsqueeze(0), s_, a_), summed, acc)
    return acc, bad


# ---------------------------------------------------------------------------
# reduce: Σ_b b·B_b per window
# ---------------------------------------------------------------------------
def reduce(buckets, d_chunk: int, arity: int, complete: bool):
    """Bucket leaves (8, W, M), M = Q·D with D = ``d_chunk`` a power of two
    -> (window sums with leaves (8, W), bad flag):
    Σ_b b·B_b = D·Σ_q q·S_q + Σ_q T_q over chunks b = q·D + j."""
    leaves = _check_points(buckets, arity, "buckets")
    if leaves[0].dim() != 3:
        raise ValueError(f"buckets: expected (8, W, M), got {tuple(leaves[0].shape)}")
    w, m_buckets = leaves[0].shape[1], leaves[0].shape[2]
    if d_chunk < 1 or d_chunk & (d_chunk - 1) or m_buckets % d_chunk:
        raise ValueError(f"chunk width {d_chunk} does not divide {m_buckets} buckets")
    dev = leaves[0].device
    if dev.type == "cpu":
        return reduce_plain(buckets, d_chunk, arity, complete)
    q = m_buckets // d_chunk
    s_sum = [torch.empty((LIMBS, w, q), dtype=torch.int32, device=dev) for _ in leaves]
    t_sum = [torch.empty_like(t) for t in s_sum]
    out = [torch.empty((LIMBS, w), dtype=torch.int32, device=dev) for _ in leaves]
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    stream = _build.stream_ptr(leaves[0])
    if w:
        (pb, _a), (ps, _b), (pt, _c), (po, _d) = map(_ptrs, (leaves, s_sum, t_sum, out))
        REDUCE.launch(1, arity, int(complete), pb, None, w, q, d_chunk, ps, pt,
                      flag.data_ptr(), stream)
        REDUCE.launch(2, arity, int(complete), ps, pt, w, q, d_chunk, po, None,
                      flag.data_ptr(), stream)
    return pa._unleaves(out, arity), flag != 0


def _double_plain(p, arity: int):
    """dbl-2009-l over the plain field (:func:`.curve_ops.jacobian_double`)."""
    dev = pa._leaves(p, arity)[0].device
    K = U64Field(C.Q, dev)
    F = BatchFq(K) if arity == 1 else BatchFq2(K)
    return tree_map(from_u64, jacobian_double(F, tree_map(to_u64, p)))


def reduce_plain(buckets, d_chunk: int, arity: int, complete: bool):
    """Plain PyTorch version of :func:`reduce`: the JAX engine's
    ``_reduce_buckets`` (a D-step double running sum at W·Q lanes, then a
    Q-step scan at W lanes) over the plain K1 (any device)."""
    dev = pa._leaves(buckets, arity)[0].device
    w, m_buckets = pa._leaves(buckets, arity)[0].shape[1:]
    q_chunk = m_buckets // d_chunk
    bad = _false(dev)

    def add(a, b):
        nonlocal bad
        pt, f = _add_plain("jadd", arity, complete, a, b)
        if f is not None:
            bad = bad | f.any()
        return pt

    # (8, W, M) -> (D, 8, W, Q) with j (minor bucket index) leading, j = D-1 first
    b4 = tree_map(lambda c_: torch.flip(c_.reshape(LIMBS, w, q_chunk, d_chunk).permute(3, 0, 1, 2), (0,)), buckets)
    zero = tree_map(lambda c_: torch.zeros_like(c_[0]), b4)  # (8, W, Q)
    running, t_sum = zero, zero
    for j in range(d_chunk - 1):  # j = D-1 .. 1
        running = add(running, tree_map(lambda c_: c_[j].contiguous(), b4))
        t_sum = add(t_sum, running)
    s_sum = add(running, tree_map(lambda c_: c_[d_chunk - 1].contiguous(), b4))  # j = 0

    # combine chunks: Σ_q q·S_q (double-running over q) and Σ_q T_q, both in
    # ONE Q-step scan at W lanes, q descending
    sq = tree_map(lambda c_: torch.flip(c_.permute(2, 0, 1), (0,)), s_sum)  # (Q, 8, W)
    tq = tree_map(lambda c_: torch.flip(c_.permute(2, 0, 1), (0,)), t_sum)
    zero_w = tree_map(lambda c_: torch.zeros_like(c_[0]), sq)
    run_s, inner, tot_t = zero_w, zero_w, zero_w
    for qq in range(q_chunk - 1):
        run_s = add(run_s, tree_map(lambda c_: c_[qq].contiguous(), sq))
        inner = add(inner, run_s)
        tot_t = add(tot_t, tree_map(lambda c_: c_[qq].contiguous(), tq))
    # q = 0 contributes only to Σ T_q
    tot_t = add(tot_t, tree_map(lambda c_: c_[q_chunk - 1].contiguous(), tq))
    for _ in range(d_chunk.bit_length() - 1):  # × D
        inner = _double_plain(inner, arity)
    return add(inner, tot_t), bad
