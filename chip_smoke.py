#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as a user would run it
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    compile the kernel sources of go_snark_study_tpu_torch/csrc with
           nvcc (sm_90a), one process each, all at once; print seconds and
           ptxas registers and spills per kernel function.  Fails if an
           instance of K3, or K4's whole-transform kernel, has a stack frame
           or spills.
  kernels  hold each kernel against its plain PyTorch version on the card,
           bit for bit, at the shapes the main path gives it: K2 on Fq and
           Fr; K1's eight per-lane instances and its MSM forms (apply,
           seg-scan, reduce; G1 and G2, incomplete and complete, and a case
           with planted equal points whose flag must fire); K3 both ways at
           every g on a ragged L and at its call sites on the 2^16 and 2^20
           paths, with its launch shape; K4's whole-transform form both ways
           at every n from 2 to 2^13 and at 3 rows of 2^12 and 2^13, timed
           at 2^12 and 2^13 with its cluster launch beside the stage path
           it replaced (the stage loop over K4's stage form, on the card);
           K4's stage form.  Each row gives the device
           time per launch from torch.profiler's device events ("device",
           the "ms" of the JSON line), the CUDA-event time of a loop of
           wrapper calls ("wrapper", the host's launch cost included), the
           plain version's time and the bound.
  main     the port's main path at 2^16 constraints: FastGroth16 setup, two
           proofs (the second timed), verification, and a wrong public that
           must fail.  Every K1 form, K2 and K3 must have launched on it, and
           K1 at most 80 times in one prove (printed by form, K3 beside it);
           a third prove runs under the profiler.
  small    the 2^12-constraint path (radix-2 NTT), as main: setup, two
           proofs (the second timed), verification, a profiled third prove.
           K4's whole-transform form must launch exactly 7 times in a prove
           and its stage form never; then the same proofs through the stage
           path, in turns with the kernel path, timed and profiled.

The kernel launch counts are set to 0 just before a path is driven and read
just after.  The second-to-last line is one JSON object with a row per
kernel; the last line is {"ok": true, "device": {...}}.  Any failure exits
non-zero before that line.  Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

PHASES = ("build", "kernels", "main", "small")
DEVICE = "cuda"
MAIN_LOG, SMALL_LOG = 16, 12  # constraints of the main path and of the radix-2 path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SMS = 132
IMAD_PER_CLK_PER_SM = 64
IMADS_PER_MONT_MUL = 264  # 8 x (16 wide products x 2 + 1): csrc/field.cuh
# kernel-check shapes, as the main path gives them
LANES_MAIN = 1 << 16  # K2: one H-pipeline product at 2^16
K1_LANES = 1 << 14  # K1: every instance, with edge-case lanes
APPLY_LANES = 24 * 2048  # K1: MSM apply step at 2^16 (24 windows x 2048)
# K3: the leaves of the four-step transforms (ops/ntt.py _col_fused): at 2^16
# two (16, 4096) per column pass; at 2^20 two (16, 65536) and one (4, 262144)
K3_SITES = (("2^16 leaf", 16, 4096), ("2^20 leaf", 16, 65536), ("2^20 leaf", 4, 262144))
K3_RAGGED = 4097  # every g, with a ragged last block
K4_LANES = 1 << 11  # K4 stage form: one radix-2 stage at 2^12
K4_MAX_LOG = 13  # K4 whole-transform form: every n from 2 to 2^13
K4_SITES = (12, 13)  # timed: the 2^12 path's transforms, and the largest
K4_PER_PROVE = 7  # radix-2 transforms per prove below 2^14 (groth16_fast._h_pipeline)
# K1's MSM forms at the 2^16 shapes: c = 11 gives 24 windows (one group),
# m_pad = 67,584 points = K 33 x m 2048, p_cap 3200, 1088 buckets = Q 17 x D 64
MSM_C, MSM_POINTS = 11, 67584
FIXED_BASE_LANES = 67584  # K1 per-lane jadd of the setup's fixed-base commits
# Montgomery products per add, Fq2 product = 3 and square = 2 Fq products
PRODUCTS = {("madd", 1): 11, ("madd", 2): 29, ("jadd", 1): 16, ("jadd", 2): 43,
            ("dbl", 1): 7, ("dbl", 2): 16}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return float(out.splitlines()[0]) * 1e6


def bound_ms(nbytes: float, imads: float, clock_hz: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = imads / (SMS * IMAD_PER_CLK_PER_SM * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


NO_STACK = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def ptxas_functions(log: str, name: str) -> dict:
    """{kernel function whose mangled name holds ``name``: (registers, its
    stack and spill line)} from ``ptxas -v`` output."""
    out, fn, props = {}, None, None
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Function properties for" in ln:
            fn, props = ln.split()[-1], lines[i + 1].strip() if i + 1 < len(lines) else ""
        elif fn and "Used" in ln and "registers" in ln:
            if name in fn:
                out[fn] = (int(ln.split("Used", 1)[1].split()[0]), props)
            fn = None
    return out


def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_ms(torch, fn, reps: int, prefixes, warm: int = 2):
    """Device time of the kernels whose names contain one of ``prefixes``,
    read from torch.profiler device events over ``reps`` calls of ``fn``:
    (ms per launch, launches per call).  The wrapper's host work (checks,
    allocation, ctypes) is not in it, unlike :func:`cuda_ms`.  A profiling
    session that records no device event at all is run again, up to three
    sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CPU and any(k in e.key for k in prefixes):
                total += _dev_us(e)
                count += e.count
        if count:
            return total / 1e3 / count, count / reps
    raise RuntimeError(f"no device events for {prefixes} in three profiling sessions")


def max_abs_err(torch, got, want) -> int:
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    err = 0
    for g, w in zip(got, want):
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
    return err


def rand_fq(torch, gen, n: int, top: int):
    """(8, n) random canonical limbs (top limb below the modulus's)."""
    x = torch.randint(0, 1 << 32, (8, n), generator=gen, device=DEVICE, dtype=torch.int64)
    x[7] = x[7] % top
    return x.to(torch.int32)


def timed(torch, fn, plain, reps: int, prefixes, plain_reps: int = 2) -> dict:
    """Device ms per launch (profiler), the wrapper loop's ms per call (CUDA
    events around Python calls: the host's launch cost included) and the plain
    version's ms per call."""
    dev, per_call = device_ms(torch, fn, reps, prefixes)
    return dict(ms=dev, device_ms=dev, launches_per_call=per_call,
                wrapper_ms=cuda_ms(torch, fn, reps),
                plain_ms=cuda_ms(torch, plain, plain_reps, warm=1) if plain else None)


def say(tag: str, what: str, t: dict, card: str):
    plain = f", plain {t['plain_ms']:.3f} ms" if t.get("plain_ms") is not None else ""
    print(f"[kernels] {tag} {what}: match, device {t['ms']:.5f} ms/launch "
          f"(x{t['launches_per_call']:g} per call), wrapper {t['wrapper_ms']:.4f} ms{plain}  ({card})")


def rand_point(torch, gen, n: int, arity: int, top: int, affine_one=None):
    comp = lambda: rand_fq(torch, gen, n, top)
    coord = (lambda: comp()) if arity == 1 else (lambda: (comp(), comp()))
    x, y, z = coord(), coord(), coord()
    if affine_one is not None:  # affine operand: z = 1 (Montgomery)
        z = affine_one if arity == 1 else (affine_one, torch.zeros_like(affine_one))
    return (x, y, z)


def check_kernels(torch, clock_hz, rows, card):
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import mont_mul as mm
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.ops.limbs import FieldKernels

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    top_q, top_r = C.Q >> 224, C.R >> 224
    k1, k2, k4 = ("point_add_kernel",), ("mont_mul_kernel",), ("butterfly_kernel",)

    # K2: Fq and Fr at 2^16 lanes
    for p, top, tag in ((C.Q, top_q, "fq"), (C.R, top_r, "fr")):
        a, b = rand_fq(torch, gen, LANES_MAIN, top), rand_fq(torch, gen, LANES_MAIN, top)
        got, want = mm.mont_mul(a, b, p), mm.mont_mul_plain(a, b, p)
        err = max_abs_err(torch, got, want)
        assert torch.equal(got, want), f"K2 {tag}: kernel != plain (max abs err {err})"
        t = timed(torch, lambda: mm.mont_mul(a, b, p), lambda: mm.mont_mul_plain(a, b, p), 200, k2, 5)
        bnd, by = bound_ms(3 * 32 * LANES_MAIN, IMADS_PER_MONT_MUL * LANES_MAIN, clock_hz)
        rows[f"K2 {tag}"] = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by, shape=f"(8, {LANES_MAIN}) {tag}")
        say("K2", f"mont_mul {tag} {LANES_MAIN} lanes", t, card)
    rows["K2"] = rows["K2 fq"]

    # K1: all 8 instances, identity / equal / inverse lanes mixed in
    n = K1_LANES
    Kq = FieldKernels(C.Q, DEVICE)
    one = Kq.ones_mont(n)
    for arity in (1, 2):
        comps = lambda: [rand_fq(torch, gen, n, top_q) for _ in range(arity)]
        for form, (_, _, flagged) in pa.FORMS.items():
            mixed = form.startswith("madd")
            c1 = [comps() for _ in range(3)]
            c2 = [comps() for _ in range(3)]
            if mixed:  # p2 affine: z = 1 (Montgomery), or 0 for identities
                c2[2] = [one.clone()] + [torch.zeros_like(one)] * (arity - 1)
            lane = torch.arange(n, device=DEVICE)
            eq, inv, id1, id2 = lane % 7 == 1, lane % 7 == 2, lane % 7 == 3, lane % 7 == 4
            if mixed:  # equal / inverse need z1 = 1 as well
                for k in range(arity):
                    c1[2][k] = torch.where((eq | inv)[None], c2[2][k], c1[2][k])
            for ci in range(3):
                for k in range(arity):
                    src = c1[ci][k]
                    if ci == 1:
                        neg = Kq.neg(src)
                        c2[ci][k] = torch.where(eq[None], src, torch.where(inv[None], neg, c2[ci][k]))
                    else:
                        c2[ci][k] = torch.where((eq | inv)[None], src, c2[ci][k])
            for k in range(arity):
                c1[2][k] = torch.where(id1[None], torch.zeros_like(one), c1[2][k])
                c2[2][k] = torch.where(id2[None], torch.zeros_like(one), c2[2][k])
            pt = lambda cs: tuple(cs[i][0] for i in range(3)) if arity == 1 else tuple((cs[i][0], cs[i][1]) for i in range(3))
            p1, p2 = pt([[t.contiguous() for t in c] for c in c1]), pt([[t.contiguous() for t in c] for c in c2])
            got = pa.point_add(form, arity, p1, p2)
            want = pa.point_add_plain(form, arity, p1, p2)
            if flagged:
                (got, gbad), (want, wbad) = got, want
                assert torch.equal(gbad, wbad), f"K1 {form} G{arity}: flags differ"
                assert bool(gbad[eq | inv].all()), f"K1 {form} G{arity}: degenerate lanes not flagged"
            gl, wl = pa._leaves(got, arity), pa._leaves(want, arity)
            err = max_abs_err(torch, gl, wl)
            assert all(torch.equal(g, w) for g, w in zip(gl, wl)), f"K1 {form} G{arity}: kernel != plain"
            t = timed(torch, lambda: pa.point_add(form, arity, p1, p2),
                      lambda: pa.point_add_plain(form, arity, p1, p2), 50, k1)
            rows.setdefault("K1_instances", []).append(
                dict(t, form=form, group=f"G{arity}", lanes=n, max_abs_err=err))
            say("K1", f"{form:6s} G{arity} {n} lanes", t, card)

    # K1 per lane at its remaining call site: the setup's fixed-base commits
    for arity in (1, 2):
        n = FIXED_BASE_LANES
        p1, p2 = rand_point(torch, gen, n, arity, top_q), rand_point(torch, gen, n, arity, top_q)
        got, want = pa.point_add("jadd", arity, p1, p2), pa.point_add_plain("jadd", arity, p1, p2)
        gl, wl = pa._leaves(got, arity), pa._leaves(want, arity)
        assert all(torch.equal(g, w) for g, w in zip(gl, wl)), f"K1 fixed-base G{arity}: kernel != plain"
        t = timed(torch, lambda: pa.point_add("jadd", arity, p1, p2), None, 100, k1)
        bnd, by = bound_ms(arity * 9 * 32 * n, PRODUCTS["jadd", arity] * IMADS_PER_MONT_MUL * n, clock_hz)
        rows.setdefault("K1_sites", []).append(dict(
            t, site="fixed-base (per-lane jadd)", group=f"G{arity}", shape=f"{n} lanes",
            max_abs_err=max_abs_err(torch, gl, wl), bound_ms=bnd, bound_by=by))
        say("K1", f"per-lane jadd G{arity} {n} lanes (fixed-base), bound {bnd:.6f} ms ({by})", t, card)
    rows["K1"] = rows["K1_sites"][0]
    check_msm_forms(torch, clock_hz, rows, card, gen)
    check_k3(torch, clock_hz, rows, card, gen)

    # K4's stage form: 2^11 lanes (one stage of the 2^12 radix-2 transform)
    n = K4_LANES
    e, o, tw4 = (rand_fq(torch, gen, n, top_r) for _ in range(3))
    got, want = nk.butterfly(e, o, tw4), nk.butterfly_plain(e, o, tw4)
    err = max_abs_err(torch, got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "K4 stage form: kernel != plain"
    t = timed(torch, lambda: nk.butterfly(e, o, tw4), lambda: nk.butterfly_plain(e, o, tw4), 500, k4, 10)
    bnd, by = bound_ms(5 * 32 * n, IMADS_PER_MONT_MUL * n, clock_hz)
    rows["K4 stage"] = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by, shape=f"(8, {n})")
    say("K4", f"stage form (butterfly) {n} lanes", t, card)
    check_k4(torch, clock_hz, rows, card, gen)


def radix2_products(n: int) -> int:
    """Montgomery products of an n-point radix-2 DIT transform, j = 0 skipped."""
    return sum(n // 2 - n // (1 << s) for s in range(1, n.bit_length()))


def check_k4(torch, clock_hz, rows, card, gen):
    """K4's whole-transform form against its plain version, forward and
    inverse, bit for bit: every n from 2 to 2^13 (each timed: device ms by
    n shows the cost of a stage and of a crossing stage), and 3 rows at
    2^12 and 2^13.  At 2^12 and 2^13 (one row, forward) it is timed beside
    its bound, the bound on the C SMs of one cluster and its launch shape;
    beside it the stage path it replaced: the stage loop (nk.radix2_stages)
    over K4's stage form on the card, its stage-kernel device time summed
    over a transform, all its device time (the glue included) and its
    wrapper time per transform."""
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk
    from go_snark_study_tpu_torch.ops.limbs import FieldKernels
    from go_snark_study_tpu_torch.ops.ntt import NTTEngine

    ntt = NTTEngine(FieldKernels(C.R, DEVICE))

    def check(n, nrows):
        x = rand_fq(torch, gen, n * nrows, C.R >> 224)
        err = 0
        for inverse in (False, True):
            T = ntt.master(n, inverse)
            got, want = nk.radix2_ntt(x, T, n), nk.radix2_ntt_plain(x, T, n)
            err = max(err, max_abs_err(torch, got, want))
            assert torch.equal(got, want), f"K4 radix2_ntt n={n} rows={nrows} inverse={inverse}: kernel != plain"
        return x, err

    by_n = {}
    for log_n in range(1, K4_MAX_LOG + 1):
        n = 1 << log_n
        x, _ = check(n, 1)
        T = ntt.master(n, False)
        ms, _ = device_ms(torch, lambda: nk.radix2_ntt(x, T), 50, ("radix2_ntt_kernel",))
        by_n[n] = dict(device_ms=ms, cluster=nk.radix2_ntt_shape(n, 1)["cluster"])
    rows["K4_by_n"] = by_n
    print(f"[kernels] K4 radix2_ntt n=2..2^{K4_MAX_LOG}, one row: forward and inverse match; device ms "
          f"(cluster size) by n: " + ", ".join(f"2^{n.bit_length() - 1} {r['device_ms']:.5f} ({r['cluster']})"
                                               for n, r in by_n.items()) + f"  ({card})")
    for log_n in K4_SITES:
        check(1 << log_n, 3)
        print(f"[kernels] K4 radix2_ntt n=2^{log_n}, 3 rows: forward and inverse match  ({card})")
    for log_n in K4_SITES:
        n = 1 << log_n
        x, err = check(n, 1)
        T = ntt.master(n, False)
        launch = nk.radix2_ntt_shape(n, 1)
        t = timed(torch, lambda: nk.radix2_ntt(x, T), lambda: nk.radix2_ntt_plain(x, T), 200,
                  ("radix2_ntt_kernel",))
        imads = radix2_products(n) * IMADS_PER_MONT_MUL
        bnd, by = bound_ms(2 * 32 * n + 32 * (n // 2), imads, clock_hz)
        cluster_ms = imads / (launch["cluster"] * IMAD_PER_CLK_PER_SM * clock_hz) * 1e3
        stage = lambda: nk.radix2_stages(x, T, None, nk.butterfly)
        assert torch.equal(stage(), nk.radix2_ntt(x, T)), f"K4 stage path n={n}: != whole-transform form"
        st_ms, st_launches = device_ms(torch, stage, 50, ("butterfly_kernel",))
        all_ms, all_launches = device_ms(torch, stage, 50, ("",))
        st_wrapper = cuda_ms(torch, stage, 50)
        stage_path = dict(device_ms=st_ms * st_launches, stage_launches=st_launches,
                          device_ms_all=all_ms * all_launches, device_launches=all_launches,
                          wrapper_ms=st_wrapper)
        rows.setdefault("K4_sites", []).append(dict(
            t, n=n, shape=f"(8, {n})", launch=launch, max_abs_err=err, bound_ms=bnd, bound_by=by,
            cluster_bound_ms=cluster_ms, products=radix2_products(n), stage_path=stage_path))
        say("K4", f"radix2_ntt n=2^{log_n} (both ways match; forward timed), bound {bnd:.6f} ms ({by}), "
            f"on the cluster's {launch['cluster']} SMs {cluster_ms:.6f} ms; {launch['ctas']} CTAs in clusters "
            f"of {launch['cluster']} x {launch['threads']} threads, {launch['shared_bytes']} shared bytes a CTA",
            t, card)
        print(f"[kernels] K4 stage path n=2^{log_n} (stage loop over the stage form): stage kernel device "
              f"{stage_path['device_ms']:.5f} ms over {st_launches:g} launches, all device "
              f"{stage_path['device_ms_all']:.5f} ms over {all_launches:g} launches, wrapper "
              f"{st_wrapper:.4f} ms per transform  ({card})")
    rows["K4"] = rows["K4_sites"][0]


def check_k3(torch, clock_hz, rows, card, gen):
    """K3 against its plain version, forward and inverse, bit for bit: every
    g on a ragged L, then each call site of the 2^16 and 2^20 paths, where
    the forward transform is timed beside its bound and launch shape."""
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk
    from go_snark_study_tpu_torch.ops.limbs import FieldKernels
    from go_snark_study_tpu_torch.ops.ntt import NTTEngine

    ntt = NTTEngine(FieldKernels(C.R, DEVICE))

    def check(g, L):
        x = rand_fq(torch, gen, g * L, C.R >> 224).reshape(8, g, L).contiguous()
        err = 0
        for inverse in (False, True):
            tw = ntt.small_table(g, inverse)
            got, want = nk.small_ntt(x, tw), nk.small_ntt_plain(x, tw)
            err = max(err, max_abs_err(torch, got, want))
            assert torch.equal(got, want), f"K3 g={g} L={L} inverse={inverse}: kernel != plain"
        return x, err

    for g in (2, 4, 8, 16):
        check(g, K3_RAGGED)
        print(f"[kernels] K3 small_ntt g={g} L={K3_RAGGED} (ragged): forward and inverse match  ({card})")
    for site, g, L in K3_SITES:
        x, err = check(g, L)
        tw = ntt.small_table(g, False)
        t = timed(torch, lambda: nk.small_ntt(x, tw), lambda: nk.small_ntt_plain(x, tw), 200, ("small_ntt_kernel",))
        launch = nk.small_ntt_shape(g, L)
        products = sum(g // 2 - (g >> s) for s in range(1, g.bit_length()))  # j != 0 butterflies
        bnd, by = bound_ms(2 * g * 32 * L + 16 * g, products * IMADS_PER_MONT_MUL * L, clock_hz)
        rows.setdefault("K3_sites", []).append(dict(
            t, site=site, shape=f"(8, {g}, {L})", launch=launch, max_abs_err=err, bound_ms=bnd, bound_by=by))
        say("K3", f"small_ntt {site} g={g} L={L} (both ways match; forward timed), bound {bnd:.6f} ms ({by}), "
            f"{launch['blocks']} blocks x {launch['threads']} threads, {launch['cols']} columns a block", t, card)
    rows["K3"] = rows["K3_sites"][0]


def check_msm_forms(torch, clock_hz, rows, card, gen):
    """K1's MSM forms against their plain versions, bit for bit and with
    equal flags, at the 2^16 shapes: apply on a real plan of random digits,
    seg-scan on its compacted partials (24 x 3200), reduce on the buckets
    (24 x 1088); G1 and G2, incomplete and complete; and the incomplete
    forms again with a third of the points equal, so that the flag fires."""
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import msm
    from go_snark_study_tpu_torch.ops import msm_kernels as mk
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.ops.curve_ops import G1Batch, tree_map
    from go_snark_study_tpu_torch.ops.limbs import FieldKernels

    Kq = FieldKernels(C.Q, DEVICE)
    top_q = C.Q >> 224
    n, c = MSM_POINTS, MSM_C
    m_buckets, d_chunk = msm.bucket_count(c)
    q_chunk = m_buckets // d_chunk
    eng = msm.MSMEngine(G1Batch(Kq), None, C.R)
    scs = torch.randint(0, 1 << 32, (8, n), generator=gen, device=DEVICE, dtype=torch.int64)
    scs[7] %= C.R >> 224
    plans = eng.make_plans(scs.to(torch.int32), c)
    assert plans["mode"] == "tiled" and len(plans["plans"]) == 1, "expected one tiled window group"
    plan = plans["plans"][0]
    k, wg, m = plan["ord3"].shape
    p_cap = plan["comp_dig"].shape[1]
    sdig = plan["comp_dig"]
    print(f"[kernels] MSM plan at the 2^16 shapes: c {c}, K {k}, Wg {wg}, m {m}, p_cap {p_cap}, "
          f"buckets {m_buckets} = Q {q_chunk} x D {d_chunk}  ({card})")
    # work these inputs need: adds that are not run openings, seg-scan lanes
    # that merge, per step
    apply_adds = int((plan["mag3"][1:] == plan["mag3"][:-1]).sum())
    lane = torch.arange(p_cap, device=DEVICE)
    seg_steps = max(1, (p_cap - 1).bit_length())
    seg_adds = sum(int(((lane >= (1 << s_)) & (torch.roll(sdig, 1 << s_, -1) == sdig)).sum())
                   for s_ in range(seg_steps))
    eq = lambda a, b, ar: all(torch.equal(x, y) for x, y in zip(pa._leaves(a, ar), pa._leaves(b, ar)))
    fired = {}
    for arity in (1, 2):
        for complete, planted in ((False, False), (True, False), (False, True)):
            tag = f"G{arity} {'complete' if complete else 'flagged'}{' planted' if planted else ''}"
            pts = rand_point(torch, gen, n, arity, top_q, Kq.ones_mont(n))
            if planted:  # every third point equal to point 0
                sel = (torch.arange(n, device=DEVICE) % 3 == 0)[None]
                pts = tree_map(lambda t: torch.where(sel, t[:, :1], t).contiguous(), pts)
            g_a, gb_a = mk.apply(pts, plan, arity, complete)
            w_a, wb_a = mk.apply_plain(pts, plan, arity, complete)
            assert eq(g_a, w_a, arity) and bool(gb_a) == bool(wb_a), f"K1 apply {tag}: kernel != plain"
            g_s, gb_s = mk.seg_scan(w_a, sdig, arity, complete)
            w_s, wb_s = mk.seg_scan_plain(w_a, sdig, arity, complete)
            assert eq(g_s, w_s, arity) and bool(gb_s) == bool(wb_s), f"K1 seg-scan {tag}: kernel != plain"
            bk = msm.MSMEngine._runs_to_buckets(w_s, sdig, m_buckets)
            g_r, gb_r = mk.reduce(bk, d_chunk, arity, complete)
            w_r, wb_r = mk.reduce_plain(bk, d_chunk, arity, complete)
            assert eq(g_r, w_r, arity) and bool(gb_r) == bool(wb_r), f"K1 reduce {tag}: kernel != plain"
            fired[tag] = (bool(wb_a), bool(wb_s), bool(wb_r))
            print(f"[kernels] K1 forms {tag}: apply, seg-scan, reduce match; flags (apply, seg, reduce) "
                  f"{fired[tag]}  ({card})")
            if planted:
                assert fired[tag][0], f"K1 apply {tag}: planted equal points did not fire the flag"
                continue
            if complete:
                continue
            # times and bounds of the incomplete forms, the main path's
            ab = 96 * arity
            forms = (
                ("apply", mk.APPLY, ("msm_apply_kernel",), lambda: mk.apply(pts, plan, arity, False),
                 lambda: mk.apply_plain(pts, plan, arity, False),
                 n * ab + k * wg * m * 21 + wg * p_cap * ab, apply_adds * PRODUCTS["madd", arity],
                 f"K {k} x {wg * m} lanes", 1),
                ("seg-scan", mk.SEG_SCAN, ("msm_seg_step_kernel",),
                 lambda: mk.seg_scan(w_a, sdig, arity, False), lambda: mk.seg_scan_plain(w_a, sdig, arity, False),
                 seg_steps * (2 * wg * p_cap * ab + 4 * wg * p_cap), seg_adds * PRODUCTS["jadd", arity],
                 f"{seg_steps} steps x {wg} x {p_cap} lanes", seg_steps),
                ("reduce-1", mk.REDUCE, ("msm_reduce1_kernel",), lambda: mk.reduce(bk, d_chunk, arity, False),
                 lambda: mk.reduce_plain(bk, d_chunk, arity, False),
                 wg * m_buckets * ab + 2 * wg * q_chunk * ab,
                 wg * q_chunk * (2 * d_chunk - 1) * PRODUCTS["jadd", arity],
                 f"{wg} x {q_chunk} lanes x {2 * d_chunk - 1} adds", 1),
                ("reduce-2", mk.REDUCE, ("msm_reduce2_kernel",), lambda: mk.reduce(bk, d_chunk, arity, False),
                 None, 2 * wg * q_chunk * ab + wg * ab,
                 wg * ((3 * q_chunk - 1) * PRODUCTS["jadd", arity]
                       + (d_chunk.bit_length() - 1) * PRODUCTS["dbl", arity]),
                 f"{wg} lanes x {3 * q_chunk - 1} adds + {d_chunk.bit_length() - 1} doublings", 1),
            )
            for site, kern, names, fn, plain, nbytes, prods, shape, per_call in forms:
                t = timed(torch, fn, plain, 5 if site == "seg-scan" else 10, names, plain_reps=1)
                bnd, by = bound_ms(nbytes / per_call, prods * IMADS_PER_MONT_MUL / per_call, clock_hz)
                rows.setdefault("K1_sites", []).append(dict(
                    t, site=site, kernel=kern.name, group=f"G{arity}", shape=shape, max_abs_err=0,
                    bound_ms=bnd, bound_by=by))
                say("K1", f"form {site} G{arity} ({shape}), bound {bnd:.6f} ms/launch ({by})", t, card)
    rows["K1_forms_flags"] = fired
    by_site = {r["site"]: r for r in rows["K1_sites"] if r["group"] == "G1"}
    rows["K1 apply"], rows["K1 seg-scan"] = by_site["apply"], by_site["seg-scan"]
    r1, r2 = by_site["reduce-1"], by_site["reduce-2"]  # one REDUCE call: both stages
    rows["K1 reduce"] = dict(
        r1, ms=(r1["ms"] + r2["ms"]) / 2, device_ms=(r1["ms"] + r2["ms"]) / 2, launches_per_call=2,
        bound_ms=(r1["bound_ms"] + r2["bound_ms"]) / 2, shape=f"stage 1 {r1['shape']}; stage 2 {r2['shape']}")


K1_FORMS = ("K1", "K1 apply", "K1 seg-scan", "K1 reduce")


def kernel_objects():
    from go_snark_study_tpu_torch.ops.mont_mul import MONT_MUL
    from go_snark_study_tpu_torch.ops.msm_kernels import APPLY, REDUCE, SEG_SCAN
    from go_snark_study_tpu_torch.ops.ntt_kernels import BUTTERFLY, RADIX2_NTT, SMALL_NTT
    from go_snark_study_tpu_torch.ops.point_add import POINT_ADD

    return {"K1": POINT_ADD, "K1 apply": APPLY, "K1 seg-scan": SEG_SCAN, "K1 reduce": REDUCE,
            "K2": MONT_MUL, "K3": SMALL_NTT, "K4": RADIX2_NTT, "K4 stage": BUTTERFLY}


def reset_counts():
    from go_snark_study_tpu_torch.ops import point_add as pa

    for k in kernel_objects().values():
        k.launches = 0
    for key in pa.INSTANCE_LAUNCHES:
        pa.INSTANCE_LAUNCHES[key] = 0


def read_counts():
    return {name: k.launches for name, k in kernel_objects().items()}


def profile_prove(torch, fast, r1cs, pk, rng, tag: str, card: str):
    """One more prove under torch.profiler: device time by kernel, and the
    device's busy share of the prove's wall time (the kernels run on one
    stream, so their summed durations are the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fast.prove(r1cs, pk, rng=rng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # device-side events only: a CPU op's device time repeats its kernels'
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU and dev(e) > 0]
    busy_us = sum(dev(e) for e in events)
    names = ("point_add_kernel", "msm_", "mont_mul_kernel", "small_ntt_kernel", "radix2_ntt_kernel",
             "butterfly_kernel")
    ours = sum(dev(e) for e in events if any(k in e.key for k in names))
    k1 = {}
    for e in events:
        for k in ("point_add_kernel", "msm_apply", "msm_seg_step", "msm_reduce1", "msm_reduce2"):
            if k in e.key:
                k1[k] = k1.get(k, 0.0) + dev(e) / 1e3
    print(f"[{tag}] profiled prove: wall {wall:.3f} s, device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall), of which K1-K4 {ours / 1e6:.4f} s; "
          f"{sum(e.count for e in events)} device launches of {len(events)} kinds  ({card})")
    print(f"[{tag}] K1 device ms in the profiled prove by kernel: "
          f"{json.dumps({k: round(v, 4) for k, v in k1.items()})}  ({card})")
    for e in sorted(events, key=dev, reverse=True)[:8]:
        print(f"[{tag}]   {dev(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    return dict(wall_s=wall, busy_s=busy_us / 1e6, launches=sum(e.count for e in events))


def run_path(torch, log_n: int, seed_rng: int, timed_second: bool, card: str):
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    tag = f"2^{log_n}"
    r1cs = mul_chain_r1cs(1 << log_n, seed=1)
    rng = random.Random(seed_rng)
    fast = FastGroth16()  # device=None: the card, as a user calls it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    setup = fast.setup(r1cs, rng=rng)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    setup_counts = read_counts()
    t0 = time.perf_counter()
    proof = fast.prove(r1cs, setup.pk, rng=rng)
    torch.cuda.synchronize()
    t_prove1 = time.perf_counter() - t0
    before = read_counts()
    t_prove2 = None
    if timed_second:
        t0 = time.perf_counter()
        proof = fast.prove(r1cs, setup.pk, rng=rng)
        torch.cuda.synchronize()
        t_prove2 = time.perf_counter() - t0
    counts = read_counts()
    prove_counts = {k: counts[k] - (before[k] if timed_second else setup_counts[k]) for k in counts}
    instances = {f"{f}/G{a}": c for (f, a), c in pa.INSTANCE_LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    t0 = time.perf_counter()
    ok = verify_proof(setup.vk, proof, publics)
    t_verify = time.perf_counter() - t0
    bad = verify_proof(setup.vk, proof, [publics[0] + 1])
    assert ok, f"{tag}: proof does not verify"
    assert not bad, f"{tag}: proof verifies with a wrong public"
    fallbacks = fast.msm_g1.fallback_hits + fast.msm_g2.fallback_hits
    print(
        f"[{tag}] setup {t_setup:.3f} s, prove (first) {t_prove1:.3f} s"
        + (f", prove (second, timed) {t_prove2:.3f} s" if timed_second else "")
        + f", verify {t_verify:.3f} s, peak device memory {peak / 2**20:.1f} MiB,"
        f" degeneracy re-runs {fallbacks}  ({card})"
    )
    print(f"[{tag}] launches during one prove: {json.dumps(prove_counts)}; whole path: "
          f"{json.dumps(counts)}  ({card})")
    print(f"[{tag}] K1 per-lane instance launches on the path: {json.dumps(instances)}  ({card})")
    k1_prove = {k: prove_counts[k] for k in K1_FORMS}
    print(f"[{tag}] K1 launches per prove by form: {json.dumps(k1_prove)}, "
          f"total {sum(k1_prove.values())}  ({card})")
    print(f"[{tag}] K3 launches per prove: {prove_counts['K3']}; K4 whole-transform {prove_counts['K4']}, "
          f"K4 stage form {prove_counts['K4 stage']}  ({card})")
    prof = profile_prove(torch, fast, r1cs, setup.pk, rng, tag, card) if timed_second else None
    return dict(setup_s=t_setup, prove_s=t_prove2 or t_prove1, counts=counts, prove_counts=prove_counts,
                peak_bytes=peak, fallbacks=fallbacks, profile=prof, fast=fast, r1cs=r1cs, setup=setup, rng=rng)


def compare_stage_path(torch, path: dict, card: str):
    """The 2^12 proofs again through the stage path that K4's whole-transform
    form replaced (NTTEngine._transform as the stage loop over K4's stage
    form, on the card): proves timed in turns, stage, kernel, kernel, stage,
    then a profiled stage-path prove; the stage-path proof must verify."""
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk

    fast, r1cs, pk, rng = path["fast"], path["r1cs"], path["setup"].pk, path["rng"]
    tag = f"2^{SMALL_LOG} stage path"

    def use(form):
        if form == "stage":
            fast.ntt._transform = lambda x, T, length=None: nk.radix2_stages(x, T, length, nk.butterfly)
        else:
            fast.ntt.__dict__.pop("_transform", None)

    times = {"stage": [], "kernel": []}
    for form in ("stage", "kernel", "kernel", "stage"):
        use(form)
        reset_counts()
        t0 = time.perf_counter()
        proof = fast.prove(r1cs, pk, rng=rng)
        torch.cuda.synchronize()
        times[form].append(time.perf_counter() - t0)
        counts = read_counts()
        want = (0, K4_PER_PROVE * SMALL_LOG) if form == "stage" else (K4_PER_PROVE, 0)
        assert (counts["K4"], counts["K4 stage"]) == want, f"{form} path: K4 launches {counts}"
        if form == "stage":
            publics = r1cs.witness[1 : r1cs.n_public + 1]
            assert verify_proof(path["setup"].vk, proof, publics), f"{tag}: proof does not verify"
    print(f"[{tag}] prove s in turns (stage, kernel, kernel, stage): stage {times['stage']}, "
          f"kernel {times['kernel']}; stage form launches per prove {K4_PER_PROVE * SMALL_LOG}  ({card})")
    use("stage")
    prof = profile_prove(torch, fast, r1cs, pk, rng, tag, card)
    use("kernel")
    return dict(prove_s=times, profile=prof)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from go_snark_study_tpu_torch import _build

    card = card_line()
    clock_hz = max_sm_clock_hz()
    print(f"[card] {card}; max SM clock {clock_hz / 1e6:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}")

    if "build" in phases:
        t0 = time.perf_counter()
        log = _build.build_all()
        print(f"[build] {len(log)} kernel sources in {time.perf_counter() - t0:.1f} s wall  ({card})")
        for name, rec in log.items():
            regs = [ln.strip().replace("ptxas info    : ", "") for ln in rec["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln or "Function properties" in ln]
            print(f"[build] {name}.cu: {rec['seconds']:.1f} s{' (cached)' if rec['cached'] else ''}  ({card})")
            for ln in regs:
                print(f"[build]   {ln}")
        spills = [ln for rec in log.values() for ln in rec["ptxas"].splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill stores")]
        print(f"[build] functions with a stack frame or spills: {len(spills)}  ({card})")
        if log["small_ntt"]["cached"]:
            print(f"[build] small_ntt.cu was cached: K3's ptxas lines are not available  ({card})")
        else:
            k3 = ptxas_functions(log["small_ntt"]["ptxas"], "small_ntt_kernel")
            for fn, (regs, props) in k3.items():
                print(f"[build] K3 {fn}: {regs} registers; {props}  ({card})")
            bad = [fn for fn, (_, props) in k3.items() if props != NO_STACK]
            assert len(k3) == 4 and not bad, f"K3 instances with a stack frame or spills: {bad} of {list(k3)}"
        if log["butterfly"]["cached"]:
            print(f"[build] butterfly.cu was cached: K4's ptxas lines are not available  ({card})")
        else:
            k4 = ptxas_functions(log["butterfly"]["ptxas"], "radix2_ntt_kernel")
            for fn, (regs, props) in k4.items():
                print(f"[build] K4 whole-transform {fn}: {regs} registers; {props}  ({card})")
            bad = [fn for fn, (_, props) in k4.items() if props != NO_STACK]
            assert len(k4) == 1 and not bad, f"K4 whole-transform kernel with a stack frame or spills: {list(k4)}"

    rows = {}
    if "kernels" in phases:
        check_kernels(torch, clock_hz, rows, card)

    paths = {}
    if "main" in phases:
        paths["main"] = run_path(torch, MAIN_LOG, 7, True, card)
        main_path = paths["main"]
        for k in K1_FORMS + ("K2", "K3"):
            assert main_path["counts"][k] > 0, f"{k} not launched on the 2^{MAIN_LOG} path"
        k1_per_prove = sum(main_path["prove_counts"][k] for k in K1_FORMS)
        assert k1_per_prove <= 80, f"K1 launched {k1_per_prove} times in one 2^{MAIN_LOG} prove"
    if "small" in phases:
        small = paths["small"] = run_path(torch, SMALL_LOG, 7, True, card)
        assert small["prove_counts"]["K4"] == K4_PER_PROVE, \
            f"K4 whole-transform launched {small['prove_counts']['K4']} times in one 2^{SMALL_LOG} prove"
        assert small["counts"]["K4 stage"] == 0, f"K4 stage form launched on the 2^{SMALL_LOG} path"
        rows["small_vs_stage_path"] = compare_stage_path(torch, small, card)

    kernels = []
    objs = kernel_objects()
    for name, obj in objs.items():
        row = rows.get(name, {})
        path = "small" if name.startswith("K4") else "main"
        launches = paths.get(path, {}).get("counts", {}).get(name)
        kernels.append({
            "name": obj.name,
            "route": "cuda",
            "source": obj.source_path,
            "replaces": obj.replaces,
            "launches": launches,
            "max_abs_err": row.get("max_abs_err"),
            "ms": row.get("ms"),
            "device_ms": row.get("device_ms"),
            "wrapper_ms": row.get("wrapper_ms"),
            "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": None,
            "match": row.get("max_abs_err") == 0 if row else None,
            "shape": row.get("shape"),
            "path": f"2^{MAIN_LOG if path == 'main' else SMALL_LOG} proof",
        })
    for key in ("K1_instances", "K1_sites", "K3_sites", "K4_sites", "K4_by_n", "small_vs_stage_path"):
        if key in rows:
            print(json.dumps({key.lower(): rows[key]}))
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
