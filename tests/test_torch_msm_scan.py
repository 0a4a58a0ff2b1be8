"""K1's MSM forms: the plain versions (``apply_plain``, ``seg_scan_plain``,
``reduce_plain`` in ``ops/msm_kernels.py``) held bit for bit, flags
included, against the JAX engine's ``_apply_impl``, ``_seg_scan_runs`` and
``_reduce_buckets`` (``go_snark_study_tpu/ops/msm.py``).  The kernels are
held against these plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Inputs are made from numpy seeds at c = 8 with 64-lane tiles: 256 affine
points (identities among them) over a 2-window group, so apply runs 4 steps
of 128 lanes and the merge scan 8 steps of 2 x 256 lanes; the reduction
takes 2 x 144 buckets.  Each case is G1 or G2, incomplete (flagged) or
complete, and the ``planted`` cases repeat points, partials and buckets so
that the degeneracy flags fire.

Each of JAX's loops compiles for tens of seconds to minutes on the CPU, so
the JAX side is a record: ``JAX_RECORD`` holds the sha256 of JAX's outputs
(in the port's limb layout) and its flags for these inputs.  Rewrite it with

    JAX_PLATFORMS=cpu python tests/test_torch_msm_scan.py --write-record

and the ``slow`` test ``test_record_is_live_jax_output`` re-derives it.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.ops import msm
from go_snark_study_tpu_torch.ops import msm_kernels as mk
from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, G2Batch
from go_snark_study_tpu_torch.ops.limbs import FieldKernels, ints_to_limbs_np

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

C_BITS, TILE, N_POINTS, WG = 8, 64, 256, 2
M_BUCKETS, D_CHUNK = msm.bucket_count(C_BITS)
CASES = [(a, complete, planted) for a in (1, 2) for complete, planted in
         ((False, False), (True, False), (False, True))]
IDS = [f"G{a}-{'planted' if p else 'complete' if c else 'flagged'}" for a, c, p in CASES]

JAX_RECORD = {
    "apply-G1-flagged": ("13b6984b07d9f76d95d6dcb480f10d695cd71d7dd8295e606a29e46a6e2b1a2f", False),
    "seg_scan-G1-flagged": ("613b05754274276bd5aae08496f112a1b68b4b08fb2271b141f921a267e15080", False),
    "reduce-G1-flagged": ("dfaeb7718f8f2d717d2d723774dc02dcc1ad2f07e5fe24638f442239ddf3d0b2", True),
    "apply-G1-complete": ("13b6984b07d9f76d95d6dcb480f10d695cd71d7dd8295e606a29e46a6e2b1a2f", False),
    "seg_scan-G1-complete": ("613b05754274276bd5aae08496f112a1b68b4b08fb2271b141f921a267e15080", False),
    "reduce-G1-complete": ("181d01f7709857e0e99ff1181f7f1f0153bd0972691677def3002a1e43bcd5e0", False),
    "apply-G1-planted": ("b234ce136335670443b67953c2c7efa96434251d9d1dd90c601c3e8ea02073f0", True),
    "seg_scan-G1-planted": ("302517f9fb2ade2d1e5ffc401010583b623a04ac44580f70edcdc13a0801c850", True),
    "reduce-G1-planted": ("d81ff9c9c3eea289e88a813380c58be49e63f6279fe2dd59984cc8628699fac0", True),
    "apply-G2-flagged": ("e6840c4ea19809d574fc571da57ab51ec5e25cd267549c07f356d4f1aad98d66", False),
    "seg_scan-G2-flagged": ("588b5e0a299e95d6a41ff786800250516158bfe9340d199e184d71ae13b59789", False),
    "reduce-G2-flagged": ("61f94d84b2551725e326c4814fa173a054c5725c546baf38feaea7b6344cadee", True),
    "apply-G2-complete": ("e6840c4ea19809d574fc571da57ab51ec5e25cd267549c07f356d4f1aad98d66", False),
    "seg_scan-G2-complete": ("588b5e0a299e95d6a41ff786800250516158bfe9340d199e184d71ae13b59789", False),
    "reduce-G2-complete": ("c2cd1660f6742d3592a4243ffd94096674f2a841a7384998d32a219a8be1425c", False),
    "apply-G2-planted": ("8731e1cd339f972803b1c86e6177bba516735fa2d34a837fa03b3e5f9a06388c", True),
    "seg_scan-G2-planted": ("29688fb9c99d4fdadb95ab578407215c860668bc7f4a4e27708387a859cd1738", True),
    "reduce-G2-planted": ("dd7d55d922a16339f98a1a4e73f26535f1339523b94109bbc7ff70b967e9119e", True),
}


def _fq(rng, shape):
    """Random canonical Fq values as (8, *shape) int32 limbs."""
    x = rng.randint(0, 1 << 32, size=(8,) + shape, dtype=np.uint64)
    x[7] %= C.Q >> 224
    return x.astype(np.uint32).view(np.int32)


def _point(rng, shape, arity, affine):
    comp = lambda: _fq(rng, shape)
    coord = (lambda: comp()) if arity == 1 else (lambda: (comp(), comp()))
    x, y, z = coord(), coord(), coord()
    if affine:
        one = np.broadcast_to(ints_to_limbs_np([(1 << 256) % C.Q]).reshape((8,) + (1,) * len(shape)),
                              (8,) + shape).copy()
        z = one if arity == 1 else (one, np.zeros_like(one))
    return (x, y, z)


def _leaves(p, arity):
    return list(p) if arity == 1 else [c for co in p for c in co]


def _unleaves(cs, arity):
    return tuple(cs) if arity == 1 else tuple((cs[2 * i], cs[2 * i + 1]) for i in range(3))


def _edit(p, arity, fn):
    return _unleaves([np.ascontiguousarray(fn(c)) for c in _leaves(p, arity)], arity)


def make_inputs(arity, planted):
    """(affine points (N), signed digits (WG, N), merge-scan points
    (WG, P), buckets (WG, M_BUCKETS)) as numpy, port layout."""
    rng = np.random.RandomState(100 + 10 * arity + planted)
    half = 1 << (C_BITS - 1)
    digits = rng.randint(-(half - 1), half + 1, size=(WG, N_POINTS)).astype(np.int32)
    digits[rng.rand(WG, N_POINTS) < 0.1] = 0
    pts = _point(rng, (N_POINTS,), arity, affine=True)
    ident = np.arange(N_POINTS) % 17 == 5
    pts = _edit(pts, arity, lambda c: np.where(ident, 0, c))
    p_cap = min(N_POINTS, M_BUCKETS + N_POINTS // max(2, N_POINTS // TILE))
    p_cap += (-p_cap) % 128
    seg = _point(rng, (WG, p_cap), arity, affine=False)
    bk = _point(rng, (WG, M_BUCKETS), arity, affine=False)
    bk = _edit(bk, arity, lambda c: np.where(np.arange(M_BUCKETS) % 5 == 3, 0, c))
    if planted:  # repeated points, equal neighbours, equal consecutive buckets
        pts = _edit(pts, arity, lambda c: np.where(np.arange(N_POINTS) % 3 == 0, c[:, :1], c))
        seg = _edit(seg, arity, lambda c: np.repeat(c[..., ::2], 2, axis=-1))
        bk = _edit(bk, arity, lambda c: np.repeat(c[..., ::2], 2, axis=-1))
    return pts, digits, seg, bk


def digest(pt, bad, arity) -> str:
    h = hashlib.sha256()
    for leaf in _leaves(pt, arity):
        h.update(np.ascontiguousarray(np.asarray(leaf, dtype=np.int32)).tobytes())
    return h.hexdigest(), bool(bad)


_ENGINES = {}


def port_engine(arity):
    """One port engine per group (plans carry no group data)."""
    if arity not in _ENGINES:
        bg = (G1Batch if arity == 1 else G2Batch)(FieldKernels(C.Q, "cpu"))
        _ENGINES[arity] = msm.MSMEngine(bg, None, C.R, window_bits=C_BITS,
                                        tile_threshold=TILE, tile_lanes=TILE)
    return _ENGINES[arity]


def _torch(p, arity):
    return _unleaves([torch.from_numpy(c) for c in _leaves(p, arity)], arity)


def _numpy(p, arity):
    return _unleaves([c.numpy() for c in _leaves(p, arity)], arity)


def port_outputs(arity, complete, planted, forms=("apply", "seg_scan", "reduce")):
    """The plain forms on the seeded inputs: {form: (sha256, flag)}."""
    pts, digits, seg, bk = make_inputs(arity, planted)
    plan = port_engine(arity)._plan_impl(torch.from_numpy(digits), C_BITS)
    out = {}
    if "apply" in forms:
        comp, bad = mk.apply_plain(_torch(pts, arity), plan, arity, complete)
        scanned, bad2 = mk.seg_scan_plain(comp, plan["comp_dig"], arity, complete)
        buckets = msm.MSMEngine._runs_to_buckets(scanned, plan["comp_dig"], M_BUCKETS)
        out["apply"] = digest(_numpy(buckets, arity), bad | bad2, arity)
    if "seg_scan" in forms:
        s_out, s_bad = mk.seg_scan_plain(_torch(seg, arity), plan["comp_dig"], arity, complete)
        out["seg_scan"] = digest(_numpy(s_out, arity), s_bad, arity)
    if "reduce" in forms:
        r_out, r_bad = mk.reduce_plain(_torch(bk, arity), D_CHUNK, arity, complete)
        out["reduce"] = digest(_numpy(r_out, arity), r_bad, arity)
    return out


def jax_outputs(arity, complete, planted):  # pragma: no cover - needs JAX, minutes
    """The JAX engine's loops on the same inputs: {form: (sha256, flag)}."""
    import jax.numpy as jnp

    from go_snark_study_tpu.bn128 import default_bn128
    from go_snark_study_tpu.ops import curve_ops as jco
    from go_snark_study_tpu.ops import msm as jmsm
    from go_snark_study_tpu.ops.fields import fq_kernels
    from go_snark_study_tpu_torch.interop import jax_to_port, port_to_jax

    bn = default_bn128()
    bg = (jco.G1Batch if arity == 1 else jco.G2Batch)(fq_kernels())
    eng = jmsm.MSMEngine(bg, bn.g1 if arity == 1 else bn.g2, C.R, window_bits=C_BITS,
                         tile_threshold=TILE, tile_lanes=TILE, complete=complete)
    pts, digits, seg, bk = make_inputs(arity, planted)
    to_j = lambda p: _unleaves([jnp.asarray(port_to_jax(c)) for c in _leaves(p, arity)], arity)
    to_p = lambda p: _unleaves([jax_to_port(np.asarray(c)) for c in _leaves(p, arity)], arity)
    plan = eng._plan_impl(jnp.asarray(digits), C_BITS)
    a_out, a_bad = eng._apply_impl(to_j(pts), plan, C_BITS)
    s_out, s_bad = eng._seg_scan_runs(to_j(seg), plan["comp_dig"])
    r_out, r_bad = eng._reduce_buckets(to_j(bk), C_BITS)
    return {
        "apply": digest(to_p(a_out), np.asarray(a_bad), arity),
        "seg_scan": digest(to_p(s_out), np.asarray(s_bad), arity),
        "reduce": digest(to_p(r_out), np.asarray(r_bad), arity),
    }


def record(outputs_fn) -> dict:
    rec = {}
    for case, cid in zip(CASES, IDS):
        for form, val in outputs_fn(*case).items():
            rec[f"{form}-{cid}"] = val
    return rec


def _check(form, case):
    arity, complete, planted = case
    cid = IDS[CASES.index(case)]
    got = port_outputs(arity, complete, planted, (form,))[form]
    assert got == JAX_RECORD[f"{form}-{cid}"], f"{form}-{cid}"
    if planted:
        assert got[1], f"{form}-{cid}: the planted case did not fire the flag"
    if complete:
        assert not got[1]


def _pick(*ids):
    return pytest.mark.parametrize("case", [CASES[IDS.index(i)] for i in ids], ids=list(ids))


# Every plain add costs tens of milliseconds on the CPU, and a reduction at
# c = 8 is 57 of them, so the cases below are cut to keep the file near
# 10 s; the card tests hold every case of every form.
@_pick(*IDS)
def test_apply_plain_matches_jax(case):
    """apply_plain, then the merge scan and the bucket scatter, against
    JAX's ``_apply_impl`` (which composes the same three)."""
    _check("apply", case)


@_pick("G1-complete", "G2-flagged", "G2-planted")
def test_seg_scan_plain_matches_jax(case):
    _check("seg_scan", case)


@_pick("G1-flagged", "G1-complete", "G1-planted", "G2-planted")
def test_reduce_plain_matches_jax(case):
    _check("reduce", case)


@pytest.mark.slow
def test_record_is_live_jax_output():
    """The committed record is what the JAX engine's loops give today."""
    assert record(jax_outputs) == JAX_RECORD


if __name__ == "__main__":  # pragma: no cover
    if "--write-record" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        rec = record(jax_outputs)
        print("JAX_RECORD = {")
        for k, (h, b) in rec.items():
            print(f'    "{k}": ("{h}", {b}),')
        print("}")
