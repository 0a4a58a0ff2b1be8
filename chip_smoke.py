#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as a user would run it
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    compile the four kernels of go_snark_study_tpu_torch/csrc with
           nvcc (sm_90a), all at once; print seconds and ptxas registers and
           spills per kernel.
  kernels  hold each kernel against its plain PyTorch version on the card,
           bit for bit, at the shapes the main path gives it; time both with
           CUDA events.
  main     the port's main path at 2^16 constraints: FastGroth16 setup, two
           proofs (the second timed), verification, and a wrong public that
           must fail.  K1, K2 and K3 must have launched during it.
  small    a 2^12-constraint proof (radix-2 NTT): K4 must have launched.

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
K3_COLS = 4096  # K3: g = 16 leaf of a 2^16 four-step transform
K4_LANES = 1 << 11  # K4: one radix-2 stage at 2^12


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


def check_kernels(torch, clock_hz, rows, card):
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import mont_mul as mm
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.ops.limbs import FieldKernels
    from go_snark_study_tpu_torch.ops.ntt import NTTEngine

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    top_q, top_r = C.Q >> 224, C.R >> 224

    # K2: Fq and Fr at 2^16 lanes
    for p, top, tag in ((C.Q, top_q, "fq"), (C.R, top_r, "fr")):
        a, b = rand_fq(torch, gen, LANES_MAIN, top), rand_fq(torch, gen, LANES_MAIN, top)
        got, want = mm.mont_mul(a, b, p), mm.mont_mul_plain(a, b, p)
        err = max_abs_err(torch, got, want)
        assert torch.equal(got, want), f"K2 {tag}: kernel != plain (max abs err {err})"
        ms = cuda_ms(torch, lambda: mm.mont_mul(a, b, p), 200)
        plain = cuda_ms(torch, lambda: mm.mont_mul_plain(a, b, p), 5, warm=1)
        if tag == "fq":
            bnd, by = bound_ms(3 * 32 * LANES_MAIN, IMADS_PER_MONT_MUL * LANES_MAIN, clock_hz)
            rows["K2"] = dict(ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bnd, bound_by=by,
                              shape=f"(8, {LANES_MAIN}) Fq")
        print(f"[kernels] K2 mont_mul {tag} {LANES_MAIN} lanes: match, kernel {ms:.4f} ms, plain {plain:.3f} ms  ({card})")

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
            ms = cuda_ms(torch, lambda: pa.point_add(form, arity, p1, p2), 50)
            plain = cuda_ms(torch, lambda: pa.point_add_plain(form, arity, p1, p2), 2, warm=1)
            rows.setdefault("K1_instances", []).append(
                dict(form=form, group=f"G{arity}", lanes=n, ms=ms, plain_ms=plain, max_abs_err=err))
            print(f"[kernels] K1 {form:6s} G{arity} {n} lanes: match, kernel {ms:.4f} ms, plain {plain:.2f} ms  ({card})")

    # K1 at the MSM apply shape of the 2^16 proof: G1 madd_f over 24 x 2048 lanes
    n = APPLY_LANES
    p1 = tuple(rand_fq(torch, gen, n, top_q) for _ in range(3))
    p2 = (rand_fq(torch, gen, n, top_q), rand_fq(torch, gen, n, top_q), Kq.ones_mont(n))
    (g_pt, g_bad), (w_pt, w_bad) = pa.point_add("madd_f", 1, p1, p2), pa.point_add_plain("madd_f", 1, p1, p2)
    assert torch.equal(g_bad, w_bad) and all(torch.equal(a, b) for a, b in zip(g_pt, w_pt)), "K1 apply shape"
    ms = cuda_ms(torch, lambda: pa.point_add("madd_f", 1, p1, p2), 100)
    plain = cuda_ms(torch, lambda: pa.point_add_plain("madd_f", 1, p1, p2), 2, warm=1)
    bnd, by = bound_ms((9 * 32 + 4) * n, 11 * IMADS_PER_MONT_MUL * n, clock_hz)
    rows["K1"] = dict(ms=ms, plain_ms=plain, max_abs_err=max_abs_err(torch, g_pt, w_pt),
                      bound_ms=bnd, bound_by=by, shape=f"G1 madd_f, {n} lanes")
    print(f"[kernels] K1 madd_f G1 {n} lanes (MSM apply step at 2^16): match, kernel {ms:.4f} ms, plain {plain:.2f} ms  ({card})")

    # K3: g = 16, forward and inverse, L = 4096
    Kr = FieldKernels(C.R, DEVICE)
    ntt = NTTEngine(Kr)
    L = K3_COLS
    x = rand_fq(torch, gen, 16 * L, top_r).reshape(8, 16, L).contiguous()
    for inverse in (False, True):
        tw = ntt.small_table(16, inverse)
        got, want = nk.small_ntt(x, tw), nk.small_ntt_plain(x, tw)
        err = max_abs_err(torch, got, want)
        assert torch.equal(got, want), f"K3 inverse={inverse}: kernel != plain"
        ms = cuda_ms(torch, lambda: nk.small_ntt(x, tw), 200)
        plain = cuda_ms(torch, lambda: nk.small_ntt_plain(x, tw), 5, warm=1)
        if not inverse:
            bnd, by = bound_ms(2 * 16 * 32 * L, 17 * IMADS_PER_MONT_MUL * L, clock_hz)
            rows["K3"] = dict(ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bnd, bound_by=by,
                              shape=f"(8, 16, {L})")
        print(f"[kernels] K3 small_ntt g=16 L={L} {'inverse' if inverse else 'forward'}: match, kernel {ms:.4f} ms, plain {plain:.3f} ms  ({card})")

    # K4: 2^11 lanes (one stage of the 2^12 radix-2 transform)
    n = K4_LANES
    e, o, t = (rand_fq(torch, gen, n, top_r) for _ in range(3))
    got, want = nk.butterfly(e, o, t), nk.butterfly_plain(e, o, t)
    err = max_abs_err(torch, got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "K4: kernel != plain"
    ms = cuda_ms(torch, lambda: nk.butterfly(e, o, t), 500)
    plain = cuda_ms(torch, lambda: nk.butterfly_plain(e, o, t), 10, warm=1)
    bnd, by = bound_ms(5 * 32 * n, IMADS_PER_MONT_MUL * n, clock_hz)
    rows["K4"] = dict(ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bnd, bound_by=by, shape=f"(8, {n})")
    print(f"[kernels] K4 butterfly {n} lanes: match, kernel {ms:.4f} ms, plain {plain:.3f} ms  ({card})")


def kernel_objects():
    from go_snark_study_tpu_torch.ops.mont_mul import MONT_MUL
    from go_snark_study_tpu_torch.ops.ntt_kernels import BUTTERFLY, SMALL_NTT
    from go_snark_study_tpu_torch.ops.point_add import POINT_ADD

    return {"K1": POINT_ADD, "K2": MONT_MUL, "K3": SMALL_NTT, "K4": BUTTERFLY}


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
    ours = sum(dev(e) for e in events if e.key.startswith(("void point_add_kernel", "void mont_mul_kernel",
                                                         "void small_ntt_kernel", "butterfly_kernel")))
    print(f"[{tag}] profiled prove: wall {wall:.3f} s, device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall), of which K1-K4 {ours / 1e6:.4f} s; "
          f"{sum(e.count for e in events)} device launches of {len(events)} kinds  ({card})")
    for e in sorted(events, key=dev, reverse=True)[:8]:
        print(f"[{tag}]   {dev(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


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
    print(f"[{tag}] launches during one prove: {json.dumps(prove_counts)}; whole path: {json.dumps(counts)}")
    print(f"[{tag}] K1 instance launches on the path: {json.dumps(instances)}")
    if timed_second:
        profile_prove(torch, fast, r1cs, setup.pk, rng, tag, card)
    return dict(setup_s=t_setup, prove_s=t_prove2 or t_prove1, counts=counts, prove_counts=prove_counts,
                peak_bytes=peak, fallbacks=fallbacks)


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
        print(f"[build] {len(log)} kernels in {time.perf_counter() - t0:.1f} s wall")
        for name, rec in log.items():
            regs = [ln.strip() for ln in rec["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
            print(f"[build] {name}.cu: {rec['seconds']:.1f} s{' (cached)' if rec['cached'] else ''}")
            for ln in regs:
                print(f"[build]   {ln}")

    rows = {}
    if "kernels" in phases:
        check_kernels(torch, clock_hz, rows, card)

    paths = {}
    if "main" in phases:
        paths["main"] = run_path(torch, MAIN_LOG, 7, True, card)
        for k in ("K1", "K2", "K3"):
            assert paths["main"]["prove_counts"][k] > 0, f"{k} not launched during the 2^{MAIN_LOG} prove"
    if "small" in phases:
        paths["small"] = run_path(torch, SMALL_LOG, 7, False, card)
        assert paths["small"]["counts"]["K4"] > 0, f"K4 not launched on the 2^{SMALL_LOG} path"

    kernels = []
    objs = kernel_objects()
    for name, obj in objs.items():
        row = rows.get(name, {})
        path = "small" if name == "K4" else "main"
        launches = paths.get(path, {}).get("counts", {}).get(name)
        kernels.append({
            "name": obj.name,
            "route": "cuda",
            "source": obj.source_path,
            "replaces": obj.replaces,
            "launches": launches,
            "max_abs_err": row.get("max_abs_err"),
            "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": None,
            "match": row.get("max_abs_err") == 0 if row else None,
            "kernel_ms": row.get("ms"),
            "shape": row.get("shape"),
            "path": f"2^{MAIN_LOG if path == 'main' else SMALL_LOG} proof",
        })
    if "K1_instances" in rows:
        print(json.dumps({"k1_instances": rows["K1_instances"]}))
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
