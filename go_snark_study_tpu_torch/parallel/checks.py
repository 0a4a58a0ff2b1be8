"""Rank programs that hold the sharded path against the single-device one.

Each function here is what one rank runs under :func:`.launch.run_ranks`
(a spawned rank imports the module that holds its function, so these live
in the package).  ``tests/test_torch_parallel.py`` runs them on the CPU
over gloo and compares their results with the JAX package's;
``chip_smoke.py`` runs :func:`card_run` on the card.  Every result is made
of plain Python values and numpy arrays, so it pickles back to the parent.
"""

from __future__ import annotations

import random
import time

import torch
import torch.distributed as dist

from ..bn128 import constants as C, default_bn128
from ..ops.curve_ops import G1Batch, tree_leaves
from ..ops.limbs import FieldKernels
from ..ops.msm import combine_window_sums
from ..profiling import launch_counts, reset_counts
from .mesh import data_mesh, hier_mesh, mesh_for
from .sharded_msm import ShardedMSMEngine
from .sharded_ntt import FourStepNTT

__all__ = [
    "mesh_report",
    "four_step",
    "msm_sums",
    "msm_hook",
    "prove",
    "shape_check",
    "card_run",
]

# shape_check's chunk: 2^14 + 3 signals over 2 ranks pad to 3 chunks a rank
SHAPE_CHUNK = 1 << 12


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_report(layouts, device) -> dict:
    """Each layout's mesh: names, shape, this rank's place on every axis,
    and the sum of the ranks of its group on every axis; then the
    ``ValueError`` texts of three meshes the world cannot hold."""
    out = {}
    for layout in layouts:
        mesh = mesh_for(layout, device)
        sums = {}
        for ax in mesh.axis_names:
            t = torch.tensor([dist.get_rank()], device=mesh.device)
            dist.all_reduce(t, group=mesh.get_group(ax))
            sums[ax] = int(t.item())
        out[layout] = dict(
            axis_names=mesh.axis_names, shape=mesh.shape, size=mesh.size(), rank=mesh.rank,
            local={ax: mesh.get_local_rank(ax) for ax in mesh.axis_names}, rank_sums=sums,
        )
    world = dist.get_world_size()
    errors = []
    for make in (lambda: data_mesh(world + 1, device), lambda: hier_mesh(world - 1, None, device),
                 lambda: hier_mesh(2, world, device)):
        try:
            make()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def four_step(coeffs, layouts, device) -> dict:
    """FourStepNTT on each layout's mesh over the Fr values ``coeffs``:
    the forward output (Montgomery limbs, numpy), whether it is the
    single-device ``NTTEngine.forward`` in ``permutation`` order, and
    whether ``inverse(forward(x)) == x``; seconds of a first forward (its
    tables built) and of a second."""
    out = {}
    for layout in layouts:
        mesh = mesh_for(layout, device)
        fs = FourStepNTT(mesh)
        x = fs.K.pack(coeffs)
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            y = fs.forward(x)
            _sync(mesh.device)
            secs.append(time.perf_counter() - t0)
        perm = torch.from_numpy(fs.permutation(len(coeffs))).to(mesh.device)
        single = fs.eng.forward(x)[:, perm]
        out[layout] = dict(
            forward=y.cpu().numpy(), matches_single=torch.equal(y, single),
            roundtrip=torch.equal(fs.inverse(y), x), forward_s=secs,
        )
    return out


def _engine(layout, device):
    mesh = mesh_for(layout, device)
    return ShardedMSMEngine(G1Batch(FieldKernels(C.Q, mesh.device)), default_bn128().g1, C.R, mesh)


def msm_sums(points, scalars, layout, device) -> dict:
    """The mesh's window sums of a G1 MSM (this rank's share of the host
    points and scalars), from the incomplete engine with its flag and from
    the complete one, as numpy limb leaves; and the complete sums combined."""
    eng = _engine(layout, device)
    pts, limbs, c = eng.pack_share(points, scalars)
    leaves = lambda s: [t.cpu().numpy() for t in tree_leaves(s)]
    inc, bad = eng.window_sums_sharded(pts, limbs, c)
    full, _ = eng.fallback_engine().window_sums_sharded(pts, limbs, c)
    return dict(c=c, local=int(limbs.shape[1]), incomplete=leaves(inc), bad=bad, complete=leaves(full),
                total=combine_window_sums(eng.host_group, eng.bg.unpack(full), c))


def msm_hook(points, scalars, layout, device) -> dict:
    """A G1 MSM through the sharded card hook
    (``models.accel.enable_gpu_msm(mesh=...)``, ``min_size=4``)."""
    from ..models import accel
    from ..models.context import default_context

    mesh = mesh_for(layout, device)
    accel.enable_gpu_msm(device=device, min_size=4, mesh=mesh)
    try:
        total = default_context().msm_g1(points, scalars)
    finally:
        accel.disable_gpu_msm()
    g1e, _ = accel.sharded_msm_engines(mesh, device)
    return dict(total=total, fallback_hits=g1e.fallback_hits)


def prove(r1cs, pk, rng, layout, device) -> dict:
    """``FastGroth16.prove_sharded`` on this rank, from a given key: the
    proof, the prover's ``rerun_counts`` and its two engines'
    ``fallback_hits``."""
    from ..models.groth16_fast import FastGroth16

    fast = FastGroth16(device=device)
    proof = fast.prove_sharded(r1cs, pk, mesh_for(layout, device), rng=rng)
    return dict(proof=proof, rerun_counts=dict(fast.rerun_counts),
                fallback_hits=fast.msm_g1.fallback_hits + fast.msm_g2.fallback_hits)


def shape_check(n_log2: int, layout, device) -> dict:
    """The dry shape rule (``sharded_prover._dry_shape``, what
    ``dry_shape_check`` runs on JAX's chunked engine) on a small chunked
    engine (``SHAPE_CHUNK`` lanes a chunk, no small family), beside the
    layout that the real sharded pipeline builds with that engine on this
    rank for the tier's signal count: lanes (``_local_lanes``, ``shard_scalars``),
    chunks, window width, windows and compaction width (``make_plans``:
    digits and sort plans on zero scalars), and the bucket count the apply
    step is given for the plan's window width."""
    from ..models.groth16_fast import FastGroth16
    from ..ops.msm import MSMEngine, bucket_count
    from .sharded_prover import ShardedFastProver, _dry_shape

    mesh = mesh_for(layout, device)
    fast = FastGroth16(device=device)
    eng = fast.msm_g1 = MSMEngine(fast.g1b, fast.ctx.bn.g1, C.R, chunk_lanes=SHAPE_CHUNK, small_chunk_lanes=0)
    prover = ShardedFastProver(fast, mesh)
    m = (1 << n_log2) + 3
    local = prover._local_lanes(m, eng)
    limbs = prover.shard_scalars([0] * m, local)
    plans = eng.make_plans(limbs, eng.window_bits_for(local))
    assert plans["mode"] == "chunk", plans["mode"]
    real = dict(local_lanes=int(limbs.shape[1]), chunks_per_shard=len(plans["chunks"]), window_bits=plans["c"],
                windows=plans["wg"] * len(plans["chunks"][0]) - plans["wpad"],
                buckets_per_window=bucket_count(plans["c"])[0],
                plan_p_cap=int(plans["chunks"][0][0]["comp_dig"].shape[1]))
    return dict(dry=_dry_shape(eng, n_log2, (1, mesh.size())), real=real)


def _held(rows: list, kernel: str, shape: str, got, want, flagged: bool = True):
    """One kernel-vs-plain comparison into ``rows``: leaves bit for bit and,
    for a flagged form, equal flags.  Returns the plain result."""
    if flagged:
        (got, got_bad), (want, want_bad) = got, want
        flags = bool(got_bad) == bool(want_bad)
    else:
        flags = True
    gl, wl = tree_leaves(got), tree_leaves(want)
    equal = len(gl) == len(wl) and all(torch.equal(g, w) for g, w in zip(gl, wl))
    rows.append(dict(kernel=kernel, shape=shape, equal=equal, flags_equal=flags))
    return want


def msm_forms_vs_plain(prover, r1cs, pk) -> list:
    """K1's MSM forms against their plain versions on this rank's inputs of
    ``prove_sharded``: its slice of the key (At in G1, B in G2) under the
    witness plan of its lanes, through the forms that plan takes (tiled:
    apply, seg-scan, reduce; small: seg-scan over the sorted stream,
    reduce), incomplete, and complete as well when the prover's flag fired.
    The inputs of each form are the plain outputs of the one before."""
    from ..models.groth16_fast import _next_pow2
    from ..ops import msm_kernels as mk
    from ..ops.curve_ops import tree_map
    from ..ops.limbs import LIMBS
    from ..ops.msm import MSMEngine, bucket_count

    fast = prover.fast
    spk = prover.shard_pk(pk, _next_pow2(r1cs.n_constraints), r1cs.n_public + 1)
    eng = fast.msm_g1
    c = eng.window_bits_for(spk.local_m)
    plans = eng.make_plans(prover.shard_scalars([x % C.R for x in r1cs.witness], spk.local_m), c)
    m_buckets, d_chunk = bucket_count(c)
    fired = fast.msm_g1.fallback_hits + fast.msm_g2.fallback_hits > 0
    rows = []
    for complete in (False, True) if fired else (False,):
        for arity, pts in ((1, spk.at), (2, spk.b2)):
            tag = f"G{arity} {'complete' if complete else 'incomplete'}"
            if plans["mode"] == "tiled":
                parts = []
                for plan in plans["plans"]:
                    k, wg, m = plan["ord3"].shape
                    sdig = plan["comp_dig"]
                    comp = _held(rows, "K1 apply", f"{tag}, K {k} x {wg} x {m} lanes", mk.apply(pts, plan, arity, complete),
                                 mk.apply_plain(pts, plan, arity, complete))
                    scanned = _held(rows, "K1 seg-scan", f"{tag}, {wg} x {sdig.shape[1]} lanes",
                                    mk.seg_scan(comp, sdig, arity, complete),
                                    mk.seg_scan_plain(comp, sdig, arity, complete))
                    parts.append(MSMEngine._runs_to_buckets(scanned, sdig, m_buckets))
                buckets = parts[0] if len(parts) == 1 else tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)
            else:  # MSMEngine._apply_small_impl's stream
                plan = plans["plan"]
                order, smag = plan["order"], plan["smag"]
                w, lanes = order.shape
                spts = tree_map(lambda t: t.index_select(1, order.reshape(-1)).reshape(LIMBS, w, lanes), pts)
                spts = mk.neg_y_where(spts, plan["sneg"], arity)
                scanned = _held(rows, "K1 seg-scan", f"{tag}, {w} x {lanes} lanes (small path)",
                                mk.seg_scan(spts, smag, arity, complete), mk.seg_scan_plain(spts, smag, arity, complete))
                buckets = MSMEngine._runs_to_buckets(scanned, smag, m_buckets)
            w = tree_leaves(buckets)[0].shape[1]
            _held(rows, "K1 reduce", f"{tag}, {w} x {m_buckets} buckets", mk.reduce(buckets, d_chunk, arity, complete),
                  mk.reduce_plain(buckets, d_chunk, arity, complete))
    return rows


def ntt_vs_plain(mesh, x: torch.Tensor) -> list:
    """K4 and K2 against their plain versions on FourStepNTT.forward's own
    inputs for the (8, n) vector ``x``: the step-B row NTTs, the step-C
    twiddle product and the step-E row NTTs of this rank.  A collective:
    every rank of ``mesh`` calls it."""
    from ..ops import mont_mul as mm, ntt_kernels as nk
    from ..ops.limbs import LIMBS

    fs = FourStepNTT(mesh)
    n = x.shape[1]
    n1, n2 = fs.split(n)
    rows = []
    b = fs._a2a_transpose(fs.local_rows(x))
    T = fs.eng.master(n1, False)
    flat = b.reshape(LIMBS, -1).contiguous()
    y = _held(rows, "K4", f"step B: {b.shape[1]} rows of {n1}", nk.radix2_ntt(flat, T, n1),
              nk.radix2_ntt_plain(flat, T, n1), flagged=False)
    tw = fs._twiddle_table(n, False).reshape(LIMBS, -1)
    y = _held(rows, "K2", f"step C: (8, {y.shape[1]}) Fr", mm.mont_mul(y, tw, C.R), mm.mont_mul_plain(y, tw, C.R),
              flagged=False)
    e = fs._a2a_transpose(y.reshape(b.shape))
    T = fs.eng.master(n2, False)
    flat = e.reshape(LIMBS, -1).contiguous()
    _held(rows, "K4", f"step E: {e.shape[1]} rows of {n2}", nk.radix2_ntt(flat, T, n2),
          nk.radix2_ntt_plain(flat, T, n2), flagged=False)
    return rows


def tree_add_vs_plain(mesh, points, windows) -> list:
    """K1's per-lane jadd against its plain version on the tree add of
    ``make_sharded_prove_step``'s MSM: this rank's window sums of its share
    of ``points`` and ``windows`` (as the step slices them), gathered over
    each axis, innermost first, and added pairwise.  A collective."""
    from ..ops import point_add as pa
    from ..ops.curve_ops import tree_map

    eng = ShardedMSMEngine(G1Batch(FieldKernels(C.Q, mesh.device)), default_bn128().g1, C.R, mesh)
    local = windows.shape[1] // mesh.size()
    lo = mesh.my_rank() * local
    mine = lambda t: t[:, lo : lo + local].contiguous()
    sums, _ = eng.window_sums_eager(eng.bg.to_affine(tree_map(mine, points)), mine(windows),
                                    eng.window_bits_for(max(1, local)))
    rows = []
    for ax in reversed(eng.axes):
        parts = eng.gather_parts(sums, ax)
        while len(parts) > 1:
            nxt = [_held(rows, "K1", f"tree add over {ax}: (8, {tree_leaves(a)[0].shape[1]}) G1 window sums",
                         pa.point_add("jadd", 1, a, b), pa.point_add_plain("jadd", 1, a, b), flagged=False)
                   for a, b in zip(parts[0::2], parts[1::2])]
            parts = nxt + parts[len(nxt) * 2 :]
        sums = parts[0]
    return rows


def card_run(log_n: int, layout, device=None, ntt: bool = False, step: bool = False,
             shape_22: bool = False) -> dict:
    """The sharded Groth16 path at 2^log_n constraints on this rank, as
    ``chip_smoke.py`` drives it: a seeded setup (``mul_chain_r1cs(2^log_n,
    seed=1)``, ``random.Random(7)``), two ``prove_sharded`` proofs from the
    rng's state after setup (the second timed), and with ``ntt`` the
    FourStepNTT check at 2^log_n, with ``step`` one
    ``make_sharded_prove_step`` at 2^log_n points and domain, with
    ``shape_22`` ``dry_shape_check(22, (2, 8))``.  The launch counts are
    set to 0 before the setup and read after these.  Then, outside the
    counts: each kernel wrapper against its plain version on this path's
    own inputs (``held``: K1's MSM forms on rank 0, with ``ntt`` K4 and K2
    on the sharded NTT's steps, with ``step`` K1's per-lane jadd on the
    tree add), and two single-device ``FastGroth16.prove`` from the same
    rng state (the second timed).  Checks: the proofs are equal as group
    elements, the sharded one verifies and fails on a wrong public input."""
    from ..models.groth16 import verify_proof
    from ..models.groth16_fast import FastGroth16
    from ..synthetic import mul_chain_r1cs
    from .prover_step import make_sharded_prove_step
    from .sharded_prover import ShardedFastProver, dry_shape_check

    out = {}
    r1cs = mul_chain_r1cs(1 << log_n, seed=1)
    fast = FastGroth16(device=device)
    reset_counts()
    rng = random.Random(7)
    t0 = time.perf_counter()
    setup = fast.setup(r1cs, rng=rng)
    _sync(fast.device)
    out["setup_s"] = time.perf_counter() - t0
    state = rng.getstate()
    mesh = mesh_for(layout, device)

    def proofs(prove_fn):
        secs = []
        for _ in range(2):
            g = random.Random()
            g.setstate(state)
            t0 = time.perf_counter()
            proof = prove_fn(g)
            _sync(fast.device)
            secs.append(time.perf_counter() - t0)
        return proof, secs

    sharded, out["sharded_prove_s"] = proofs(lambda g: fast.prove_sharded(r1cs, setup.pk, mesh, rng=g))
    if ntt:
        draw = random.Random(3)
        coeffs = [draw.randrange(C.R) for _ in range(1 << log_n)]
        out["ntt"] = {k: {f: v for f, v in r.items() if f != "forward"}
                      for k, r in four_step(coeffs, [layout], device).items()}
    if step:
        fn, example = make_sharded_prove_step(mesh, 1 << log_n, 1 << log_n)
        t0 = time.perf_counter()
        sums, h = fn(*example)
        _sync(fast.device)
        out["step"] = dict(seconds=time.perf_counter() - t0, sums_shape=tuple(sums[0].shape),
                           h_shape=tuple(h.shape))
    if shape_22:
        out["shape_22"] = dry_shape_check(22, (2, 8))
    out["counts"] = launch_counts()
    held = []
    if mesh.my_rank() == 0:
        held += msm_forms_vs_plain(ShardedFastProver(fast, mesh), r1cs, setup.pk)
    if ntt:
        held += ntt_vs_plain(mesh, fast.Kr.pack(coeffs))
    if step:
        held += tree_add_vs_plain(mesh, example[0], example[1])
    out["held"] = held
    single, out["single_prove_s"] = proofs(lambda g: fast.prove(r1cs, setup.pk, rng=g))

    bn = default_bn128()
    out["equal"] = (bn.g1.equal(sharded.pi_a, single.pi_a) and bn.g2.equal(sharded.pi_b, single.pi_b)
                    and bn.g1.equal(sharded.pi_c, single.pi_c))
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    out["verifies"] = verify_proof(setup.vk, sharded, publics)
    out["wrong_public_fails"] = not verify_proof(setup.vk, sharded, [publics[0] + 1])
    out["proof"] = sharded
    out["device"] = str(mesh.device)
    out["fallbacks"] = fast.msm_g1.fallback_hits + fast.msm_g2.fallback_hits
    return out
