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
           K4's stage form; NTTEngine._transform on 2 rows of 2^14 and 1 row of
           2^15 (the four-step form) against the plain radix-2 loop; the
           prover's SpMV (ops/r1cs_spmv.py) at the 2^20 SHA-256 shape (the
           benchmark's 1,984-byte circuit) against the host C++ products
           entered by K2, the route it replaced, and against its plain
           version, with the seconds that building its rows takes.  Each
           row gives the device
           time per launch from torch.profiler's device events ("device",
           the "ms" of the JSON line), the CUDA-event time of a loop of
           wrapper calls ("wrapper", the host's launch cost included), the
           plain version's time and the bound.
  main     the port's main path at 2^16 constraints: FastGroth16 setup, two
           proofs (the second timed), verification, and a wrong public that
           must fail.  Every K1 form, K2, K3 and the SpMV must have launched
           on it, the SpMV once a prove, and
           K1 at most 80 times in one prove (printed by form, K3 beside it);
           a third prove runs under the profiler.
  small    the 2^12-constraint path (radix-2 NTT), as main: setup, two
           proofs (the second timed), verification, a profiled third prove.
           K4's whole-transform form must launch exactly 7 times in a prove
           and its stage form never; then the same proofs through the stage
           path, in turns with the kernel path, timed and profiled.
  dsl      the README's --fast recipe at 2^16 constraints, without the CLI:
           flat-code source of a 2^16 - 1 link multiplication chain ->
           parse_source -> calculate_witness(field_modulus=R) ->
           SparseR1CS.from_circuit -> FastGroth16 on the card, as main.
           K1 at most 80 and K3 exactly 28 launches a prove; prints the
           compile, witness and sparse seconds, row_evals through the C++
           and the Python route, and proves in turns with each route.
  parity   the parity protocols (api's groth16 and pinocchio flows) with
           the card hooks on (models.accel: enable_gpu_msm, enable_gpu_setup)
           and then on the host, on the cubic circuit (min_size 4) and a
           128-link DSL power chain (min_size 64): both verify, a wrong public
           fails, every key and proof point from the card equals the host's
           as a group element, K1's reduce form launches at least twice per
           MSM of a proof, and the per-lane K1 add and K2 launch.
  cli      the port's CLI (go_snark_study_tpu_torch.cli.main, in-process, on
           the card) in a temporary directory on the dsl phase's 2^16
           chain: compile --fast, groth16 trustedsetup --fast (the binary
           key file), groth16 genproofs --fast twice (each a fresh main()
           call), groth16 verify (exit 0) and again on a tampered public
           input (exit 1).  At most 80 K1 and exactly 28 K3 launches per
           genproofs.  Then one more genproofs with GOSNARK_MSM_PROFILE=1
           (the profiler's rows); on one engine, setups with and without
           host lists in turns; the key file round trip of main's 2^16
           setup (this phase's own when main did not run), every tensor
           equal; and the first prove on a fresh engine without and with a
           warmup, beside a second prove and a profiled third.

  sharded  the multi-device prover (go_snark_study_tpu_torch.parallel) on
           ranks spawned by parallel.launch.run_ranks, after the kernels are
           built in this process: NCCL with one rank at 2^16 constraints;
           gloo with two ranks sharing the card at 2^16, with the sharded
           four-step NTT at 2^16 (bit for bit the single-device forward in
           its permuted order, and inverse(forward(x)) == x) and one sharded
           prove step at 2^16 points and domain; gloo on a 2x2 (host, data)
           mesh of four ranks on the card at 2^12, with
           dry_shape_check(22, (2, 8)).  On every rank: a seeded setup, two
           prove_sharded proofs and two FastGroth16.prove proofs from the
           same rng state (the second of each timed); they must be equal as
           group elements, the sharded proof must verify and fail on a wrong
           public input, and every rank of a run must return the same proof.
           Each rank sends back its launch counts (setup, sharded proofs and
           the NTT and step checks; not the single-device proofs): summed,
           they are the path's, and K1's four forms, K2, K3 and K4 must each
           be above 0.  Outside the counts, every run holds each wrapper
           against its plain version, bit for bit with equal flags, on its
           own inputs: K1's MSM forms on rank 0's witness plan (G1 and G2;
           complete too where a flag fired), K4 and K2 on the sharded NTT's
           steps, K1's jadd on the tree add's window sums.  Then
           scaling.run's weak-scaling rows for 1 and 2 gloo ranks.  Prints
           one {"sharded": ...} line.
  ladder   bench.py's program (bench.py:319-609) through the stage functions
           of the port's bench (go_snark_study_tpu_torch/bench.py), on one
           FastGroth16 (device=None): its warmup (the kernels, the
           MSM pieces, the H pipeline of each tier's domain, the fixed-base
           tables); bench.py's serial baseline (its rng's first 8 draws, so
           that the MSMs get bench.py's inputs); the 2^20 G1 MSM over
           distinct points k_i·G made on the
           card (scalars_to_windows, fb_g1.batch_mul_device,
           to_affine_tiled), window_sums_checked three times, the result
           equal to (Σ s_i·k_i)·G; the 2^20 NTT (two forwards, the round
           trip bit for bit, a fresh engine's first forward, 4 evaluations
           against host Horner values); Montgomery products at 2^20 lanes
           over fr_kernels(); the tiers 2^14, 2^16, 2^18 and 2^20 of
           mul_chain_r1cs (setup without host lists with its setup.* spans,
           a cold and a warm prove, verification, a wrong public that must
           fail, the key's device bytes, peak memory; K3 per prove must be
           k3_per_prove's count, K2's k2_per_prove's and, at 2^20, K1's
           per prove the count the plans predict, with no flag fired; a
           profiled 2^20 prove and its prove.* spans); the 2^21 G1 MSM
           (its multipliers drawn before its scalars, as bench.py's are),
           with the garbage collector's pauses in its timed window and the
           allocator's device allocations.
           Then, outside the counts, the host bridge on the 2^20 prove's
           inputs: the C++ runtime must be built, and the prover's input
           tensors (the three H inputs, w_limbs, wp_limbs) and the setup's
           ptau commit vector, through the bytes-and-K2 route, must equal
           the Python route's (Python ints, Montgomery form on the host)
           bit for bit, each route timed per 2^20 vector; the commit
           vector's commit must equal the key's.  Then every kernel on the
           2^20 prove's own inputs, timed beside its
           bound and held against its plain version bit for bit with equal
           flags: K1's forms on the last, zero-padded window group of the
           witness plan in G1 and in G2 on that plan (the reduce on every
           group's buckets), K1's jadd on a fixed-base window step, K2 on
           the H pipeline's first coset product, K3 on its first three
           leaves; and to_affine against to_affine_tiled in turns.  Last,
           the 2^21 MSM twice more, once with the 2^20 key dropped and once
           with its system dropped too, watched as the first.  Prints
           one {"ladder": ...} line with bench.py's metric names.
  chunked  the JAX engine's accelerator configuration on the card: one
           FastGroth16 (device=None) whose msm_g1 has both chunk families
           (2^17 lanes at c = 13, 2^14 at c = 11 up to 2^15 lanes) and whose
           msm_g2 has the big one only; its warmup(families=("big",
           "small")) (each step's seconds); the tiers 2^14 (the witness in
           2 small chunks, G2 on its own plan at c = 13) and 2^20 (a key
           padded to 9 chunks, 1,179,648 lanes at at/b1/b2), each as a
           ladder tier (setup, cold and warm prove, verification, a wrong
           public that must fail; K1's launches per warm prove, the
           cross-chunk adds included, must be what the layouts predict, K2
           and K3 k2_per_prove's and k3_per_prove's; a profiled 2^20
           prove); the 2^20 and 2^21 G1 MSMs as the ladder runs them, in 8
           and 16 chunks, equal to (Σ s_i·k_i)·G.  After the counts are
           read: the 2^20 key proved by the chunked and the default
           (unchunked) engines in turns from one rng state, every proof
           equal, and a profiled unchunked prove; then K1 at the chunk
           shapes on the 2^20 prove's own inputs, timed beside its bound
           and held bit for bit with equal flags against its plain
           version: the apply and merge-scan forms on the last,
           zero-padded chunk of the witness plan (G1, and G2 on that plan),
           the per-lane jadd_f on the first two chunks' buckets (the
           cross-chunk add, G1 and G2), the reduce on the sum of every
           chunk's buckets (G1).  One {"chunked": ...} line.
  bench    python -m go_snark_study_tpu_torch.bench as a user runs it, in
           its own process, with GOSNARK_BENCH_MSM=65536 GOSNARK_BENCH_NTT=
           65536 GOSNARK_BENCH_PROVE=14 GOSNARK_BENCH_MSM21=0 (BENCH_ENV): it
           must exit 0 and print bench.py's line last, headline
           msm_g1_points_per_sec_2^16, correct, no error_* key, the three
           shares of sub.mfu at most 1, this card's name and power limit,
           and K1's forms, K2 and K3 launched in its run (it sets its counts
           to 0 at its start and reports them at its end).  Prints the line
           as {"bench": ...}.

The kernel launch counts are set to 0 just before a path is driven and read
just after (the parity flows: before and after each setup and proof; the
sharded path: in each rank, before its setup and after its checks; the
ladder and chunked phases: before the warmup and after the 2^21 MSM; the
bench phase: in the bench's own process, at its start and end).  Each of
the dsl, parity and cli phases prints one JSON line of its numbers.  The
seconds of each phase and of the whole script are printed before the card's
name.  The second-to-last line is one JSON object with a row per
kernel; the last line is {"ok": true, "device": {...}}.  Any failure exits
non-zero before that line.  Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import subprocess
import sys
import time

PHASES = ("build", "kernels", "main", "small", "dsl", "parity", "cli", "sharded", "ladder", "chunked", "bench")
DEVICE = "cuda"
MAIN_LOG, SMALL_LOG = 16, 12  # constraints of the main path and of the radix-2 path
DSL_LOG = 16  # the dsl phase: a flat-code chain of 2^16 - 1 links, 2^16 constraints
K3_PER_PROVE = 28  # K3 launches per 2^16 prove: 7 four-step NTTs x 2 column passes x 2 leaves
PARITY_LINKS = 128  # the parity phase's DSL power chain: 132 signals, every MSM >= 64 points
TRANSFORM_ROWS = ((2, 1 << 14), (1, 1 << 15))  # NTTEngine._transform above K4's 2^13: rows, n
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
SPMV_MESSAGE_BYTES = 1984  # the SpMV's check: the benchmark's SHA-256 circuit, 1,018,304 rows, domain 2^20
# K1's MSM forms at the 2^16 shapes: c = 11 gives 24 windows (one group),
# m_pad = 67,584 points = K 33 x m 2048, p_cap 3200, 1088 buckets = Q 17 x D 64
MSM_C, MSM_POINTS = 11, 67584
FIXED_BASE_LANES = 67584  # K1 per-lane jadd of the setup's fixed-base commits
# the sharded phase: (label, backend, ranks, mesh layout, log2 constraints,
# NTT and prove-step checks, 2^22 shape check); the 2x2 run is cut to 2^12
SHARDED_RUNS = (
    ("nccl x1", "nccl", 1, 1, 16, False, False),
    ("gloo x2", "gloo", 2, 2, 16, True, False),
    ("gloo 2x2", "gloo", 4, (2, 2), 12, False, True),
)
SCALING_PER_RANK = 1 << 15  # the 2^16 witness MSM's lanes over 2 ranks
# the ladder phase: bench.py's program through the port (bench.py:319-609)
LADDER_TIERS = (14, 16, 18, 20)  # log2 constraints (bench.py:328-332 runs 16, 20, 14, 18)
LADDER_MSM_LOGS = (20, 21)  # the G1 MSMs of bench.py:352-417 and :583-609
LADDER_NTT_LOG = 20  # bench.py:419-444
LADDER_SEED = 0xBEEF  # bench.py's rng
NTT_SAMPLES = 4  # evaluations checked against a host Horner evaluation
MODMUL_LANES = 1 << 20  # bench.py:446-476
# the chunked phase: the JAX engine's chunk families (ops/msm.py), its tiers and MSMs
BIG_CHUNK, SMALL_CHUNK = 1 << 17, 1 << 14
CHUNK_TIERS = (14, 20)  # the small family's witness (2 chunks), the big family's (9 chunks)
CHUNK_MSM_LOGS = (20, 21)  # 8 and 16 big chunks
# the bench phase: python -m go_snark_study_tpu_torch.bench at these sizes (bench.py's variables)
BENCH_ENV = {"GOSNARK_BENCH_MSM": "65536", "GOSNARK_BENCH_NTT": "65536", "GOSNARK_BENCH_PROVE": "14",
             "GOSNARK_BENCH_MSM21": "0"}
BENCH_TIMEOUT_S = 600


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
    """(least ms, what bounds it) on the port's H100 model
    (``profiling.CHIP_MODELS["h100"]``) at the card's SM clock."""
    from go_snark_study_tpu_torch.profiling import CHIP_MODELS

    s, by = CHIP_MODELS["h100"].at_clock(clock_hz).bound_s(nbytes, imads)
    return s * 1e3, by


def cost_bound(kind: str, n: int, clock_hz: float, **shape):
    """bound_ms of ``profiling.kernel_cost(kind, n, **shape)``."""
    from go_snark_study_tpu_torch.profiling import kernel_cost

    c = kernel_cost(kind, n, **shape)
    return bound_ms(c["bytes"], c["int32_ops"], clock_hz)


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
        bnd, by = cost_bound("mont_mul", LANES_MAIN, clock_hz)
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
        t = timed(torch, lambda: pa.point_add("jadd", arity, p1, p2),
                  lambda: pa.point_add_plain("jadd", arity, p1, p2), 100, k1)
        bnd, by = cost_bound("point_add", n, clock_hz, group=arity)
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
    bnd, by = cost_bound("butterfly", n, clock_hz)
    rows["K4 stage"] = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by, shape=f"(8, {n})")
    say("K4", f"stage form (butterfly) {n} lanes", t, card)
    check_k4(torch, clock_hz, rows, card, gen)
    check_long_rows(torch, card, gen)
    check_spmv(torch, clock_hz, rows, card)


def check_spmv(torch, clock_hz, rows, card):
    """The prover's SpMV at the 2^20 SHA-256 shape: circomlib's SHA-256 over
    SPMV_MESSAGE_BYTES, the witness of a seeded message.  The kernel, on the
    witness rows as the prover copies them, against the route it replaced
    (the host C++ products, ``SparseR1CS._products_into``, each entered by
    ``FieldKernels.pack_bytes``) and against its plain version on the card,
    bit for bit.  Prints the rows' build seconds (``SparseR1CS._csr`` and
    the rest of ``row_csr``), the host products' seconds, device ms a
    launch beside the bound (``RowCSR.cost``), the plain version's ms and
    the launches a call."""
    import numpy as np

    from go_snark_study_tpu_torch import native
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.circuits import sha256
    from go_snark_study_tpu_torch.models.groth16_fast import _next_pow2
    from go_snark_study_tpu_torch.ops import r1cs_spmv as sp
    from go_snark_study_tpu_torch.ops.limbs import FieldKernels, bytes_to_rows

    assert native.available(), "the C++ host runtime (native/libgosnark_native.so) is not built"
    t0 = time.perf_counter()
    r1cs = sha256.sha256_r1cs(SPMV_MESSAGE_BYTES)
    r1cs.witness = sha256.witness(r1cs, random.Random(21).randbytes(SPMV_MESSAGE_BYTES))
    t_circuit = time.perf_counter() - t0
    n = _next_pow2(r1cs.n_constraints)
    torch.zeros(1, device=DEVICE)  # the CUDA context, before the clocks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r1cs._csr()
    t_host_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = sp.row_csr(r1cs, n, DEVICE)
    torch.cuda.synchronize()
    t_rows = time.perf_counter() - t0
    w = np.empty(32 * len(r1cs.witness), dtype=np.uint8)
    outs = tuple(np.empty(32 * len(rs), dtype=np.uint8) for rs in (r1cs.A, r1cs.B, r1cs.C))
    r1cs._witness_into(w)
    t0 = time.perf_counter()
    r1cs._products_into(w, outs)
    t_host = time.perf_counter() - t0
    Kr = FieldKernels(C.R, DEVICE)
    want = torch.stack([Kr.pack_bytes(o.tobytes(), lanes=n) for o in outs])
    w_rows = bytes_to_rows(torch.from_numpy(w), DEVICE)
    got = sp.r1cs_spmv(csr, w_rows)
    err = max_abs_err(torch, got, want)
    assert torch.equal(got, want), f"SpMV: kernel != the host products (max abs err {err})"
    assert torch.equal(got, sp.r1cs_spmv_plain(csr, w_rows)), "SpMV: kernel != plain"
    t = timed(torch, lambda: sp.r1cs_spmv(csr, w_rows), lambda: sp.r1cs_spmv_plain(csr, w_rows), 50,
              ("r1cs_spmv_kernel",), 1)
    cost = csr.cost()
    bnd, by = bound_ms(cost["bytes"], cost["int32_ops"], clock_hz)
    lens = torch.diff(csr.indptr)
    shape = (f"SHA-256 {SPMV_MESSAGE_BYTES} bytes: 3 x {n} rows, {csr.cols.numel()} non-zeros, "
             f"{csr.long_rows.numel()} rows of more than {sp.WARP}, {csr.table.shape[0]} table entries")
    rows["SpMV"] = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by, shape=shape, products=cost["products"],
                        bytes=cost["bytes"], longest_row=int(lens.max()), circuit_s=t_circuit,
                        host_csr_s=t_host_csr, row_csr_s=t_rows, host_products_s=t_host)
    say("SpMV", f"{shape}, bound {bnd:.4f} ms ({by}); rows built in {t_host_csr:.2f} s (_csr) + {t_rows:.2f} s "
        f"(row_csr); the host products took {t_host:.3f} s", t, card)
    print(json.dumps({"spmv": {k: v for k, v in rows["SpMV"].items()}}))


def check_long_rows(torch, card, gen):
    """NTTEngine._transform on rows above K4's 2^13 (the four-step form, K3
    leaves and K2 twiddles, a row at a time) against the plain radix-2 stage
    loop, forward and inverse, bit for bit."""
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk
    from go_snark_study_tpu_torch.ops.limbs import FieldKernels
    from go_snark_study_tpu_torch.ops.ntt import NTTEngine

    ntt = NTTEngine(FieldKernels(C.R, DEVICE))
    for nrows, n in TRANSFORM_ROWS:
        x = rand_fq(torch, gen, nrows * n, C.R >> 224)
        for inverse in (False, True):
            T = ntt.master(n, inverse)
            got, want = ntt._transform(x, T, n), nk.radix2_ntt_plain(x, T, n)
            assert torch.equal(got, want), f"_transform {nrows} x 2^{n.bit_length() - 1} inverse={inverse}: != plain"
        print(f"[kernels] NTTEngine._transform {nrows} row(s) of 2^{n.bit_length() - 1} (four-step): forward and "
              f"inverse match the plain radix-2 loop  ({card})")


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
    from go_snark_study_tpu_torch.profiling import H100_IMAD_PER_CLK_PER_SM, kernel_cost

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
        cost = kernel_cost("radix2_ntt", n)
        imads = cost["int32_ops"]
        bnd, by = cost_bound("radix2_ntt", n, clock_hz)
        cluster_ms = imads / (launch["cluster"] * H100_IMAD_PER_CLK_PER_SM * clock_hz) * 1e3
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
            cluster_bound_ms=cluster_ms, products=cost["products"], stage_path=stage_path))
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
        bnd, by = cost_bound("small_ntt", L, clock_hz, g=g)  # its j != 0 butterflies
        rows.setdefault("K3_sites", []).append(dict(
            t, site=site, shape=f"(8, {g}, {L})", launch=launch, max_abs_err=err, bound_ms=bnd, bound_by=by))
        say("K3", f"small_ntt {site} g={g} L={L} (both ways match; forward timed), bound {bnd:.6f} ms ({by}), "
            f"{launch['blocks']} blocks x {launch['threads']} threads, {launch['cols']} columns a block", t, card)
    rows["K3"] = rows["K3_sites"][0]


def msm_form_costs(torch, plan, n_points: int, arity: int, bk, d_chunk: int):
    """K1's four MSM forms at one window group's shapes, for their bounds:
    (site, kernel, device-name prefixes, bytes, IMADs, shape, launches per
    call).  Bytes: each input read once, each output written once.  IMADs:
    the adds these inputs need (apply: the adds that are not run openings;
    seg-scan: the lanes that merge, per step; reduce: every add of its
    chains).  ``bk``: the buckets the reduce form takes, (8, W, M)."""
    from go_snark_study_tpu_torch.ops import msm_kernels as mk
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.profiling import kernel_cost

    k, wg, m = plan["ord3"].shape
    sdig = plan["comp_dig"]
    p_cap = sdig.shape[1]
    w_red, m_buckets = pa._leaves(bk, arity)[0].shape[1:]
    q_chunk = m_buckets // d_chunk
    apply_adds = int((plan["mag3"][1:] == plan["mag3"][:-1]).sum())
    lane = torch.arange(p_cap, device=sdig.device)
    seg_steps = max(1, (p_cap - 1).bit_length())
    seg_adds = sum(int(((lane >= (1 << s_)) & (torch.roll(sdig, 1 << s_, -1) == sdig)).sum())
                   for s_ in range(seg_steps))
    ab = 96 * arity  # bytes of one Jacobian point
    imads = lambda kind, count: kernel_cost(kind, count, group=arity)["int32_ops"]
    return (
        ("apply", mk.APPLY, ("msm_apply_kernel",), n_points * ab + k * wg * m * 21 + wg * p_cap * ab,
         imads("point_add_mixed", apply_adds), f"K {k} x {wg * m} lanes", 1),
        ("seg-scan", mk.SEG_SCAN, ("msm_seg_step_kernel",), seg_steps * (2 * wg * p_cap * ab + 4 * wg * p_cap),
         imads("point_add", seg_adds), f"{seg_steps} steps x {wg} x {p_cap} lanes", seg_steps),
        ("reduce-1", mk.REDUCE, ("msm_reduce1_kernel",), w_red * m_buckets * ab + 2 * w_red * q_chunk * ab,
         imads("point_add", w_red * q_chunk * (2 * d_chunk - 1)),
         f"{w_red} x {q_chunk} lanes x {2 * d_chunk - 1} adds", 1),
        ("reduce-2", mk.REDUCE, ("msm_reduce2_kernel",), 2 * w_red * q_chunk * ab + w_red * ab,
         imads("point_add", w_red * (3 * q_chunk - 1))
         + imads("point_double", w_red * (d_chunk.bit_length() - 1)),
         f"{w_red} lanes x {3 * q_chunk - 1} adds + {d_chunk.bit_length() - 1} doublings", 1),
    )


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
            calls = {
                "apply": (lambda: mk.apply(pts, plan, arity, False), lambda: mk.apply_plain(pts, plan, arity, False)),
                "seg-scan": (lambda: mk.seg_scan(w_a, sdig, arity, False),
                             lambda: mk.seg_scan_plain(w_a, sdig, arity, False)),
                "reduce-1": (lambda: mk.reduce(bk, d_chunk, arity, False),
                             lambda: mk.reduce_plain(bk, d_chunk, arity, False)),
                "reduce-2": (lambda: mk.reduce(bk, d_chunk, arity, False), None),
            }
            for site, kern, names, nbytes, ops, shape, per_call in msm_form_costs(torch, plan, n, arity, bk, d_chunk):
                fn, plain = calls[site]
                t = timed(torch, fn, plain, 5 if site == "seg-scan" else 10, names, plain_reps=1)
                bnd, by = bound_ms(nbytes / per_call, ops / per_call, clock_hz)
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
             "butterfly_kernel", "r1cs_spmv_kernel")
    ours = sum(dev(e) for e in events if any(k in e.key for k in names))
    k1 = {}
    for e in events:
        for k in ("point_add_kernel", "msm_apply", "msm_seg_step", "msm_reduce1", "msm_reduce2"):
            if k in e.key:
                k1[k] = k1.get(k, 0.0) + dev(e) / 1e3
    print(f"[{tag}] profiled prove: wall {wall:.3f} s, device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall), of which the port's kernels {ours / 1e6:.4f} s; "
          f"{sum(e.count for e in events)} device launches of {len(events)} kinds  ({card})")
    print(f"[{tag}] K1 device ms in the profiled prove by kernel: "
          f"{json.dumps({k: round(v, 4) for k, v in k1.items()})}  ({card})")
    k1_launches = {}
    for e in events:
        for k in ("point_add_kernel", "msm_apply", "msm_seg_step", "msm_reduce1", "msm_reduce2"):
            if k in e.key:
                k1_launches[k] = k1_launches.get(k, 0) + e.count
    for e in sorted(events, key=dev, reverse=True)[:8]:
        print(f"[{tag}]   {dev(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    return dict(wall_s=wall, busy_s=busy_us / 1e6, launches=sum(e.count for e in events), k1_ms=k1,
                k1_launches=k1_launches)


def run_path(torch, tag: str, r1cs, seed_rng: int, timed_second: bool, card: str):
    """FastGroth16 on the card (device=None) over one sparse system: setup,
    a prove, a second one timed, verification, a wrong public; the launch
    counts are set to 0 just before the setup and read after the proves."""
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.profiling import launch_counts, reset_counts

    rng = random.Random(seed_rng)
    fast = FastGroth16()  # device=None: the card, as a user calls it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    setup = fast.setup(r1cs, rng=rng)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    setup_counts = launch_counts()
    t0 = time.perf_counter()
    proof = fast.prove(r1cs, setup.pk, rng=rng)
    torch.cuda.synchronize()
    t_prove1 = time.perf_counter() - t0
    before = launch_counts()
    t_prove2 = None
    if timed_second:
        t0 = time.perf_counter()
        proof = fast.prove(r1cs, setup.pk, rng=rng)
        torch.cuda.synchronize()
        t_prove2 = time.perf_counter() - t0
    counts = launch_counts()
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
    from go_snark_study_tpu_torch.profiling import launch_counts, reset_counts

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
        counts = launch_counts()
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


def chain_source(n_links: int, seed: int = 7):
    """Flat-code multiplication chain t_k = t_{k-1} * t_{k-2}, n_links links
    and an output binding (n_links + 1 constraints): (source, private
    inputs, public inputs).  The generator of tests/test_sparse_cli.py."""
    from go_snark_study_tpu_torch.bn128.constants import R

    rng = random.Random(seed)
    s0, s1 = rng.randrange(2, R), rng.randrange(2, R)
    lines = ["func main(private s0, private s1, public out):"]
    a, b, va, vb = "s0", "s1", s0, s1
    for k in range(n_links):
        lines.append(f"t{k} = {a} * {b}")
        a, b, va, vb = b, f"t{k}", vb, va * vb % R
    lines.append(f"out = {b} * 1")
    return "\n".join(lines) + "\n", [s0, s1], [vb]


def power_chain_source(n_links: int, x: int = 3):
    """Flat-code chain s_1 = s0 * s0, s_{i+1} = s_i * s0 up to s_n, bound to
    the public output (tests/test_accel.py's native-witness circuit): n + 3
    constraints, n + 4 signals.  Its raw-integer witness stays small (x^(n+1)),
    which the parity path's compile_circuit computes without reduction.
    Returns (source, private inputs, public inputs)."""
    from go_snark_study_tpu_torch.bn128.constants import R

    body = "\n".join(f"\ts{i + 1} = s{i} * s0" for i in range(1, n_links))
    src = ("func main(private s0, public out1):\n\ts1 = s0 * s0\n" + body
           + f"\n\tequals(out1, s{n_links})\n\tout = 1 * 1\n")
    return src, [x], [pow(x, n_links + 1, R)]


def native_route(card: str) -> dict:
    """Load (or make, with ``make -C native``) the C++ host runtime; say
    which route the witness and row evaluations take."""
    from go_snark_study_tpu_torch import native

    present = os.path.exists(native.LIB_PATH)
    t0 = time.perf_counter()
    ok = native.available()
    secs = time.perf_counter() - t0
    how = "present" if present else (f"made with make in {secs:.1f} s" if ok else "could not be made")
    print(f"[native] libgosnark_native.so {how}: witness and row_evals take the "
          f"{'C++' if ok else 'Python'} route  ({card})")
    return dict(native=ok, library=how)


@contextlib.contextmanager
def python_route():
    """The witness and row evaluations take their Python route meanwhile,
    as where the C++ library is absent."""
    from go_snark_study_tpu_torch import native

    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def run_dsl(torch, card: str, main_path, route: dict):
    """The README's --fast recipe without the CLI: flat-code source of a
    2^16-constraint chain -> parse_source -> field-mode witness ->
    SparseR1CS.from_circuit -> FastGroth16 on the card."""
    from go_snark_study_tpu_torch.bn128.constants import R
    from go_snark_study_tpu_torch.circuitcompiler import parse_source
    from go_snark_study_tpu_torch.synthetic import SparseR1CS

    src, priv, pub = chain_source((1 << DSL_LOG) - 1)
    t0 = time.perf_counter()
    circuit = parse_source(src)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = circuit.calculate_witness(priv, pub, field_modulus=R)
    t_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    r1cs = SparseR1CS.from_circuit(circuit, witness=w)
    t_sparse = time.perf_counter() - t0
    assert r1cs.n_constraints == 1 << DSL_LOG, r1cs.n_constraints
    assert r1cs.witness[1 : r1cs.n_public + 1] == pub
    t_rows = []  # the first call of the C++ route builds the CSR arrays it keeps
    for _ in range(2):
        t0 = time.perf_counter()
        evals = r1cs.row_evals()
        t_rows.append(time.perf_counter() - t0)
    with python_route():
        t0 = time.perf_counter()
        evals_py = r1cs.row_evals()
        t_rows_py = time.perf_counter() - t0
    assert evals == evals_py, "row_evals: the C++ and Python routes differ"
    print(f"[dsl] {r1cs.n_constraints} constraints, {r1cs.n_signals} signals: parse {t_parse:.3f} s, witness "
          f"{t_witness:.3f} s, from_circuit {t_sparse:.3f} s; row_evals {t_rows[0]:.3f} s then {t_rows[1]:.3f} s "
          f"({'C++' if route['native'] else 'Python'} route), {t_rows_py:.3f} s (Python route)  ({card})")
    tag = f"dsl 2^{DSL_LOG}"
    path = run_path(torch, tag, r1cs, 7, True, card)
    for k in K1_FORMS + ("K2", "K3"):
        assert path["counts"][k] > 0, f"{k} not launched on the {tag} path"
    k1_per_prove = sum(path["prove_counts"][k] for k in K1_FORMS)
    assert k1_per_prove <= 80, f"K1 launched {k1_per_prove} times in one {tag} prove"
    assert path["prove_counts"]["K3"] == K3_PER_PROVE, f"K3 launched {path['prove_counts']['K3']} times in one prove"
    # the prove's row evaluations through each route, in turns
    fast, pk, rng = path["fast"], path["setup"].pk, path["rng"]
    turns = {"python": [], "native": []}
    for which in ("python", "native", "native", "python"):
        with python_route() if which == "python" else contextlib.nullcontext():
            t0 = time.perf_counter()
            fast.prove(r1cs, pk, rng=rng)
            torch.cuda.synchronize()
            turns[which].append(time.perf_counter() - t0)
    print(f"[{tag}] prove s in turns by the witness encoder's route (python, native, native, python): {json.dumps(turns)}  "
          f"({card})")
    line = dict(card=card, constraints=r1cs.n_constraints, signals=r1cs.n_signals, **route,
                parse_s=t_parse, witness_s=t_witness, from_circuit_s=t_sparse,
                row_evals_s=t_rows, row_evals_python_s=t_rows_py, setup_s=path["setup_s"],
                prove_s=path["prove_s"], main_mul_chain_prove_s=main_path["prove_s"] if main_path else None,
                prove_s_by_row_evals_route=turns, k1_per_prove=k1_per_prove,
                prove_counts=path["prove_counts"], fallbacks=path["fallbacks"], profile=path["profile"],
                peak_bytes=path["peak_bytes"])
    print(json.dumps({"dsl": line}))
    return path


PARITY_MSMS = {"groth16": 5, "pinocchio": 8}  # MSMs in one proof


def parity_run(proto: str, bundle, seed: int, card_hooks, tag: str):
    """One parity flow, in the order of api.groth16_flow / pinocchio_flow:
    trusted setup, proof, verification (and a wrong public).  With
    ``card_hooks`` = min_size the card's hooks are on, the launch counts
    are set to 0 before each step and read after it, and the flow's entry
    point runs once more and must give the same setup and proof.  The hooks
    return host points, so each step's clock includes the card's work.
    ``fallback_hits``: the proof's MSMs whose flag fired."""
    from go_snark_study_tpu_torch import api
    from go_snark_study_tpu_torch.models import accel, groth16, pinocchio
    from go_snark_study_tpu_torch.profiling import launch_counts, reset_counts

    mod = groth16 if proto == "groth16" else pinocchio
    flow = api.groth16_flow if proto == "groth16" else api.pinocchio_flow
    circuit, w = bundle.circuit, bundle.witness
    publics = w[1 : circuit.n_public + 1]
    on_card = card_hooks is not None
    if on_card:
        accel.enable_gpu_msm(min_size=card_hooks)
        accel.enable_gpu_setup(min_size=card_hooks)
    engines = accel.msm_engines()
    hits0 = sum(e.fallback_hits for e in engines)
    out, counts = {}, {}
    try:
        rng = random.Random(seed)
        reset_counts()
        t0 = time.perf_counter()
        setup = mod.generate_trusted_setup(len(w), circuit, bundle.alphas, bundle.betas, bundle.gammas, rng=rng)
        out["setup_s"] = time.perf_counter() - t0
        counts["setup"] = launch_counts()
        reset_counts()
        t0 = time.perf_counter()
        if proto == "groth16":
            proof = mod.generate_proofs(circuit, setup.pk, w, bundle.px, rng=rng)
        else:
            proof = mod.generate_proofs(circuit, setup.pk, w, bundle.px)
        out["prove_s"] = time.perf_counter() - t0
        counts["prove"] = launch_counts()
        out["fallback_hits"] = sum(e.fallback_hits for e in engines) - hits0
        t0 = time.perf_counter()
        ok = mod.verify_proof(setup.vk, proof, publics)
        out["verify_s"] = time.perf_counter() - t0
        assert ok, f"[{tag}] {proto}: proof does not verify"
        assert not mod.verify_proof(setup.vk, proof, [publics[0] + 1]), f"[{tag}] {proto}: a wrong public verifies"
        if on_card:
            reset_counts()
            t0 = time.perf_counter()
            fsetup, fproof, fok = flow(bundle, rng=random.Random(seed))
            out["flow_s"] = time.perf_counter() - t0
            counts["flow"] = launch_counts()
            assert fok, f"[{tag}] {proto}_flow does not verify"
            assert same_points(fsetup, setup) and same_points(fproof, proof), f"[{tag}] {proto}_flow differs"
    finally:
        if on_card:
            accel.disable_gpu_msm()
            accel.disable_gpu_setup()
    return setup, proof, out, counts


def same_points(got, want) -> int:
    """Number of group elements in two setups or proofs, field by field,
    or 0 if any differs (G2 points have Fq2 coordinates)."""
    import dataclasses

    from go_snark_study_tpu_torch.bn128 import default_bn128

    bn = default_bn128()

    def eq(a, b):
        if isinstance(a, tuple) and len(a) == 3:
            return 1 if (bn.g2 if isinstance(a[0], tuple) else bn.g1).equal(a, b) else None
        if isinstance(a, list) and a and isinstance(a[0], tuple):
            if len(a) != len(b):
                return None
            parts = [eq(x, y) for x, y in zip(a, b)]
        elif dataclasses.is_dataclass(a):
            parts = [eq(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)]
        else:
            return 0 if a == b else None
        return None if None in parts else sum(parts)

    return eq(got, want) or 0


def run_parity(card: str):
    """The parity protocols with the card hooks on (enable_gpu_msm and
    enable_gpu_setup, device=None) against the same flows on the host, on
    the cubic circuit (min_size 4) and a 128-link DSL power chain (min_size
    64, the default): both verify, a wrong public fails, every key and proof
    point from the card equals the host's as a group element."""
    from go_snark_study_tpu_torch import api
    from go_snark_study_tpu_torch.profiling import kernel_objects

    cubic = """
func main(private s0, public s1):
	s2 = s0 * s0
	s3 = s2 * s0
	s4 = s3 + s0
	s5 = s4 + 5
	equals(s1, s5)
	out = 1 * 1
"""
    circuits = (("cubic", (cubic, [3], [35]), 4), (f"chain {PARITY_LINKS}", power_chain_source(PARITY_LINKS), 64))
    total = {k: 0 for k in kernel_objects()}
    lines = []
    for name, (src, priv, pub), min_size in circuits:
        t0 = time.perf_counter()
        bundle = api.compile_circuit(source=src, private_inputs=priv, public_inputs=pub)
        t_qap = time.perf_counter() - t0
        n_sig = len(bundle.witness)
        print(f"[parity {name}] compile_circuit (parse, witness, R1CS, QAP on the host) {t_qap:.3f} s, "
              f"{n_sig} signals, px of {len(bundle.px)} coefficients  ({card})")
        for proto in ("groth16", "pinocchio"):
            tag = f"parity {name} {proto}"
            seed = 31 if proto == "groth16" else 32
            setup, proof, on, counts = parity_run(proto, bundle, seed, min_size, tag)
            hsetup, hproof, host, _ = parity_run(proto, bundle, seed, None, tag)
            n_key, n_proof = same_points(setup, hsetup), same_points(proof, hproof)
            assert n_key > 0, f"[{tag}] a key point from the card differs from the host's"
            assert n_proof > 0, f"[{tag}] a proof point from the card differs from the host's"
            reduce_per_msm = counts["prove"]["K1 reduce"] / PARITY_MSMS[proto]
            assert reduce_per_msm >= 2, f"[{tag}] K1 reduce launched {counts['prove']['K1 reduce']} times in a proof"
            assert counts["setup"]["K1"] > 0, f"[{tag}] the per-lane K1 add did not launch in the setup"
            assert counts["prove"]["K2"] > 0, f"[{tag}] K2 did not launch in the proof"
            for phase in ("setup", "prove"):
                for k, v in counts[phase].items():
                    total[k] += v
            print(f"[{tag}] card: setup {on['setup_s']:.3f} s, prove {on['prove_s']:.3f} s, verify "
                  f"{on['verify_s']:.3f} s, {proto}_flow {on['flow_s']:.3f} s, degeneracy re-runs "
                  f"{on['fallback_hits']}; host: setup {host['setup_s']:.3f} s, prove {host['prove_s']:.3f} s, "
                  f"verify {host['verify_s']:.3f} s; {n_key} key and {n_proof} proof points equal  ({card})")
            print(f"[{tag}] launches: setup {json.dumps(counts['setup'])}; proof {json.dumps(counts['prove'])}  "
                  f"({card})")
            lines.append(dict(circuit=name, protocol=proto, signals=n_sig, min_size=min_size, qap_compile_s=t_qap,
                              card=on, host=host, launches=counts, key_points_equal=n_key,
                              proof_points_equal=n_proof, k1_reduce_per_msm=reduce_per_msm))
    print(json.dumps({"parity": {"card": card, "flows": lines}}))
    return dict(counts=total)



def cli_call(torch, argv):
    """One call of the port's CLI as a user makes it, on the card (main's
    device=None): (exit code, wall seconds)."""
    from go_snark_study_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0


def device_pk_leaves(dpk) -> dict:
    """{name: tensor} of every tensor of a DevicePk."""
    out = {}
    for f in ("at", "b1", "b2", "cdelta", "ptau"):
        for ci, coord in enumerate(getattr(dpk, f)):
            for k, t in enumerate(coord if isinstance(coord, tuple) else (coord,)):
                out[f"{f}.{ci}.{k}"] = t
    return out


def profiled(fn):
    """Run ``fn`` with GOSNARK_MSM_PROFILE=1 and a fresh profiler:
    {label: {"s", "calls"}} of its spans."""
    from go_snark_study_tpu_torch.profiling import profiling

    with profiling() as prof:
        fn()
    return {k: dict(s=prof.times[k], calls=prof.calls[k]) for k in sorted(prof.times)}


def say_profile(what: str, rows: dict, card: str):
    print(f"[cli] spans of {what} (GOSNARK_MSM_PROFILE=1)  ({card}): {json.dumps(rows)}")


def run_cli(torch, card: str, paths: dict):
    """The --fast CLI flow at 2^16 constraints on the card, through the
    binary key file; then the key file's round trip, setups with and
    without host lists, and the first prove with and without a warmup."""
    import tempfile

    from go_snark_study_tpu_torch.cli.main import _load_compiled_sparse
    from go_snark_study_tpu_torch.models.groth16 import verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.profiling import launch_counts, reset_counts
    from go_snark_study_tpu_torch.utils import keyfile

    src, priv, pub = chain_source((1 << DSL_LOG) - 1)
    secs, per_prove = {}, []
    old = os.getcwd()

    def run(tag, argv, want_rc):
        rc, t = cli_call(torch, argv)
        assert rc == want_rc, f"[cli] {tag}: exit code {rc}, expected {want_rc}"
        secs.setdefault(tag, []).append(t)
        print(f"[cli] {tag}: exit {rc}, {t:.3f} s  ({card})")

    with tempfile.TemporaryDirectory(prefix="cli-") as d:
        os.chdir(d)
        try:
            with open("chain.circuit", "w") as fh:
                fh.write(src)
            with open("privateInputs.json", "w") as fh:
                json.dump([str(x) for x in priv], fh)
            with open("publicInputs.json", "w") as fh:
                json.dump([str(x) for x in pub], fh)
            reset_counts()
            run("compile --fast", ["compile", "chain.circuit", "--fast"], 0)
            run("groth16 trustedsetup --fast", ["groth16", "trustedsetup", "--fast"], 0)
            for _ in range(2):
                before = launch_counts()
                run("groth16 genproofs --fast", ["groth16", "genproofs", "--fast"], 0)
                after = launch_counts()
                c = {k: after[k] - before[k] for k in after}
                k1 = sum(c[k] for k in K1_FORMS)
                assert k1 <= 80, f"[cli] K1 launched {k1} times in one genproofs"
                assert c["K3"] == K3_PER_PROVE, f"[cli] K3 launched {c['K3']} times in one genproofs"
                per_prove.append(c)
            run("groth16 verify", ["groth16", "verify"], 0)
            with open("publicInputs.json", "w") as fh:
                json.dump([str(pub[0] + 1)], fh)
            run("groth16 verify, tampered public", ["groth16", "verify"], 1)
            with open("publicInputs.json", "w") as fh:
                json.dump([str(x) for x in pub], fh)
            counts = launch_counts()
            for k in K1_FORMS + ("K2", "K3"):
                assert counts[k] > 0, f"{k} not launched on the cli path"
            key_bytes = os.path.getsize(keyfile.KEYFILE)
            profile = profiled(lambda: run("groth16 genproofs --fast, GOSNARK_MSM_PROFILE=1",
                                           ["groth16", "genproofs", "--fast"], 0))
            for label in ("msm.plan", "msm.apply+badd", "msm.reduce", "prove.msm", "prove"):
                assert label in profile, f"[cli] no {label} in the profile"
            _, r1cs = _load_compiled_sparse()
        finally:
            os.chdir(old)
    print(f"[cli] launches per genproofs: {json.dumps(per_prove)}; whole flow {json.dumps(counts)}  ({card})")
    print(f"[cli] key file {key_bytes} bytes  ({card})")
    say_profile("one genproofs --fast", profile, card)

    # one engine: setups with and without host lists, in turns, its
    # fixed-base tables built first
    fast = FastGroth16()
    fast.warmup(families=(), fixed_base=True)
    setup_s = {"materialize_host": [], "no_host_lists": []}
    for mat in (False, True, True, False):
        t0 = time.perf_counter()
        setup = fast.setup(r1cs, rng=random.Random(11), materialize_host=mat)
        torch.cuda.synchronize()
        setup_s["materialize_host" if mat else "no_host_lists"].append(time.perf_counter() - t0)
        assert len(setup.pk.g1.at) == (r1cs.n_signals if mat else 0)
        if not mat:
            own = setup
    print(f"[cli] setup s in turns (no host lists, host lists, host lists, no host lists): "
          f"{json.dumps(setup_s)}  ({card})")

    # the key file round trip, every tensor equal on the card
    src_setup, src_name = (paths["main"]["setup"], "main") if "main" in paths else (own, "cli")
    with tempfile.TemporaryDirectory(prefix="key-") as d:
        path = os.path.join(d, keyfile.KEYFILE)
        t0 = time.perf_counter()
        keyfile.save_fast_setup(path, src_setup.strip_toxic())
        t_save = time.perf_counter() - t0
        rt_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = keyfile.load_fast_setup(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    want, got = src_setup.pk._device, loaded.pk._device
    for f in ("n", "m", "lo", "m_pad", "mp_pad", "n_pad"):
        assert getattr(got, f) == getattr(want, f), f"[cli] key file round trip: {f} differs"
    gl, wl = device_pk_leaves(got), device_pk_leaves(want)
    assert gl.keys() == wl.keys()
    for name in wl:
        assert gl[name].is_cuda and torch.equal(gl[name], wl[name]), f"[cli] key file round trip: {name} differs"
    assert loaded.vk.ic == src_setup.vk.ic and loaded.pk.g2.delta == src_setup.pk.g2.delta
    print(f"[cli] key file round trip of {src_name}'s 2^{DSL_LOG} setup: {len(wl)} tensors equal; {rt_bytes} bytes, "
          f"save {t_save:.3f} s, load onto the card {t_load:.3f} s  ({card})")

    # the first prove on a fresh engine, without and with a warmup
    pk, rng = own.pk, random.Random(12)

    def prove(engine):
        t0 = time.perf_counter()
        proof = engine.prove(r1cs, pk, rng=rng)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    cold = FastGroth16()
    _, t_cold = prove(cold)
    _, t_second = prove(cold)
    warm_profile = profiled(lambda: prove(cold))  # a third prove on that engine
    say_profile("a third prove on that engine", warm_profile, card)
    warm = FastGroth16()
    t0 = time.perf_counter()
    steps = warm.warmup(domains=(1 << DSL_LOG,), fixed_base=True)
    t_warmup = time.perf_counter() - t0
    proof, t_warm = prove(warm)
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    assert verify_proof(own.vk, proof, publics), "[cli] the proof after the warmup does not verify"
    print(f"[cli] first prove on a fresh engine {t_cold:.3f} s, its second {t_second:.3f} s; warmup "
          f"{t_warmup:.3f} s ({json.dumps(steps)}), then the first prove {t_warm:.3f} s  ({card})")
    line = dict(card=card, constraints=r1cs.n_constraints, command_s=secs, launches_per_genproofs=per_prove,
                key_bytes=key_bytes, roundtrip=dict(setup=src_name, bytes=rt_bytes, save_s=t_save, load_s=t_load,
                                                    tensors_equal=len(wl)),
                setup_s=setup_s, first_prove_s=t_cold, second_prove_s=t_second, warmup_s=t_warmup,
                warmup_steps_s=steps, first_prove_after_warmup_s=t_warm, profile=profile,
                warm_prove_profile=warm_profile)
    print(json.dumps({"cli": line}))
    return dict(counts=counts)


def k3_per_prove(n: int) -> int:
    """K3 launches in one prove at domain n, from ops/ntt.py: seven
    transforms (groth16_fast._h_pipeline: four inverse, three forward), each
    two column passes of NTTEngine._col_fused, whose leaves are K3 (one leaf
    of 16 rows, then the rest recursively)."""
    from go_snark_study_tpu_torch.ops.ntt import NTTEngine

    leaves = lambda n_len: 1 if n_len <= NTTEngine.RADIX else 1 + leaves(n_len // NTTEngine.RADIX)
    if n < NTTEngine.FOURSTEP_MIN:
        return 0
    n1, n2 = NTTEngine.split(n)
    return 7 * (leaves(n1) + leaves(n2))


def k2_per_prove(n: int) -> int:
    """K2 launches in one prove at domain n when no flag fires, from the
    code (the H inputs enter the Montgomery domain in the SpMV, no K2):
    the H pipeline's own products (groth16_fast._h_pipeline: four 1/n
    scales, four coset shifts, the coset product, the 1/Z scale, the
    Montgomery exit: 11); the twiddle products of its seven transforms
    (NTTEngine._transform_fourstep: the step table's, and one per level of
    each column pass above the 16-point leaf; none below 2^14, where K4
    takes the transform); and the Montgomery exits of the five MSMs'
    window sums (four G1 MSMs x 3 coordinates, the G2 MSM's 6: 18)."""
    from go_snark_study_tpu_torch.ops.ntt import NTTEngine

    levels = lambda n_len: 0 if n_len <= NTTEngine.RADIX else 1 + levels(n_len // NTTEngine.RADIX)
    per_transform = 0
    if n >= NTTEngine.FOURSTEP_MIN:
        n1, n2 = NTTEngine.split(n)
        per_transform = levels(n1) + levels(n2) + 1
    return 11 + 7 * per_transform + 18


def k1_per_prove(fast, dpk):
    """K1's launches that one prove's plans predict when no flag fires, and
    the plans' layouts: each of the five MSMs launches an apply per window
    group of each chunk, the merge-scan steps of each, two reduce launches,
    and a per-lane add per chunk after the first (the cross-chunk ``badd``).
    The witness plan serves At and B1 in G1 and B2 in G2, unless G2's
    window width differs (no small chunk family there): then G2 plans by
    its own rules."""
    g1, g2 = fast.msm_g1, fast.msm_g2
    b2 = g1 if g2.window_bits_for(dpk.m_pad) == g1.window_bits_for(dpk.m_pad) else g2
    lays = {name: eng.layout(lanes) for name, eng, lanes in
            (("at", g1, dpk.m_pad), ("b1", g1, dpk.m_pad), ("b2", b2, dpk.m_pad), ("cdelta", g1, dpk.mp_pad),
             ("h", g1, dpk.n_pad))}
    out = {"K1": 0, "K1 apply": 0, "K1 seg-scan": 0, "K1 reduce": 0}
    for lay in lays.values():
        applies = lay["groups"] * lay["chunks"] if lay["mode"] != "small" else 0
        out["K1 apply"] += applies
        out["K1 seg-scan"] += max(applies, 1) * lay["seg_steps"]
        out["K1 reduce"] += 2
        out["K1"] += lay.get("badds", 0)
    return out, lays


def group_layout(lay: dict) -> str:
    if lay["mode"] == "small":
        return f"small path, c {lay['c']}"
    chunks = f"{lay['chunks']} chunk(s) of {lay['span']} lanes, " if lay["mode"] == "chunk" else ""
    return (f"{chunks}c {lay['c']}, {lay['w']} windows in {lay['groups']} group(s) of {lay['wg']} ({lay['wpad']} "
            f"zero), K {lay['k']} x m {lay['m']}, p_cap {lay['p_cap']}, {lay['seg_steps']} merge-scan steps")


def ladder_msm(torch, fast, log_n: int, rng, runs: int, card: str, phase: str = "ladder") -> dict:
    """bench.py's G1 MSM through the port's bench (go_snark_study_tpu_torch.bench):
    at 2^LADDER_MSM_LOGS[0] its msm_stage (the scalars drawn from ``rng``
    first, then the multipliers; ``runs`` runs, the second timed), above it
    its msm21_stage (the multipliers first, one run).  The 2^log_n points
    k_i·G are made on the card by the fixed-base engine and normalised by
    to_affine_tiled; each run is window_sums_checked and the host
    combination, timed end to end as bench.py times it, and must equal
    (Σ s_i·k_i)·G."""
    from go_snark_study_tpu_torch import bench

    n = 1 << log_n
    if log_n == LADDER_MSM_LOGS[0]:
        out = bench.msm_stage(fast, n, rng, "distinct", runs=runs)
    else:
        out = bench.msm21_stage(fast, rng, n)
    assert out["correct"], f"[{phase}] G1 MSM 2^{log_n} != (sum s_i k_i) G"
    lay, ms, hits = out["layout"], out["ms"], out["fallback_hits"]
    print(f"[{phase}] G1 MSM 2^{log_n}: {ms:.1f} ms ({n / ms * 1e3:.0f} points/s; runs {out['runs_s']} s), "
          f"equals the host oracle; {group_layout(lay)}; degeneracy re-runs {hits}; random scalars and "
          f"multipliers {out['random_s']:.2f} s, points k_i G on the card (fixed-base, to_affine_tiled) and scalar "
          f"limbs {out['points_s']:.2f} s, peak device memory of that step "
          f"{out['points_peak_bytes'] / 2**20:.1f} MiB  ({card})")
    return dict(n=n, c=out["c"], layout=lay, ms=ms, runs_s=out["runs_s"], points_per_sec=n / ms * 1e3,
                fallback_hits=hits, random_s=out["random_s"], points_s=out["points_s"],
                points_peak_bytes=out["points_peak_bytes"])


def watched_msm(torch, fast, fn):
    """Run ``fn`` (an MSM stage on ``fast``'s G1 engine) and return (its
    result, what the process did meanwhile): the garbage collector's
    pauses by generation from the first window_sums_checked call to the
    stage's end (the timed window), the wall of the window sums (fenced;
    the rest of the window is the host combination), the caching
    allocator's device allocations and retries over the stage, and the
    bytes allocated and reserved after it."""
    eng, gen_pause, mark = fast.msm_g1, [0.0, 0.0, 0.0], {}
    checked = eng.window_sums_checked

    def first_call(*a, **k):
        t0 = time.perf_counter()
        mark.setdefault("t0", t0)
        sums = checked(*a, **k)
        torch.cuda.synchronize()
        mark["sums_ms"] = mark.get("sums_ms", 0.0) + (time.perf_counter() - t0) * 1e3
        return sums

    def on_gc(phase, info):
        if phase == "start":
            mark["gc"] = time.perf_counter()
        elif "t0" in mark and mark["gc"] >= mark["t0"]:
            gen_pause[info["generation"]] += time.perf_counter() - mark["gc"]

    mem0, col0 = torch.cuda.memory_stats(), [g["collections"] for g in gc.get_stats()]
    eng.window_sums_checked = first_call
    gc.callbacks.append(on_gc)
    try:
        out = fn()
    finally:
        gc.callbacks.remove(on_gc)
        del eng.window_sums_checked
    mem1 = torch.cuda.memory_stats()
    return out, dict(window_sums_ms=mark.get("sums_ms"), gc_pause_ms_by_gen=[t * 1e3 for t in gen_pause],
                     gc_collections_by_gen=[g["collections"] - c for g, c in zip(gc.get_stats(), col0)],
                     device_allocs=mem1.get("num_device_alloc", 0) - mem0.get("num_device_alloc", 0),
                     alloc_retries=mem1.get("num_alloc_retries", 0) - mem0.get("num_alloc_retries", 0),
                     allocated_mib=torch.cuda.memory_allocated() / 2**20,
                     reserved_mib=torch.cuda.memory_reserved() / 2**20, gc_tracked_objects=len(gc.get_objects()))


def msm21_by_residency(torch, fast, rng, first: dict, top: dict, card: str) -> list:
    """Where the 2^21 MSM's time goes when the 2^20 tier stays resident:
    ``first`` is the ladder's own 2^21 run (key and system resident); then
    one run after the key is dropped (its device memory back in the
    allocator's cache, the system's Python objects kept) and one after the
    system is dropped too.  Each with ``watched_msm``'s readings."""
    rows = [dict(state="2^20 key and system resident", ms=first["ms"], **first["watch"])]
    for state, drop in (("key dropped, system resident", "setup"), ("key and system dropped", "r1cs")):
        del top[drop]
        gc.collect()
        out, watch = watched_msm(torch, fast, lambda: ladder_msm(torch, fast, LADDER_MSM_LOGS[1], rng, 1, card))
        rows.append(dict(state=state, ms=out["ms"], **watch))
    for r in rows:
        print(f"[ladder] 2^21 MSM with the {r['state']}: {r['ms']:.1f} ms, window sums {r['window_sums_ms']:.1f} "
              f"ms; GC pauses in the timed window by generation {[round(t, 1) for t in r['gc_pause_ms_by_gen']]} "
              f"ms, collections over the stage "
              f"{r['gc_collections_by_gen']}, {r['gc_tracked_objects']} tracked objects; device allocations "
              f"{r['device_allocs']}, retries {r['alloc_retries']}; allocated {r['allocated_mib']:.0f} MiB, "
              f"reserved {r['reserved_mib']:.0f} MiB  ({card})")
    return rows


def ladder_ntt(torch, fast, log_n: int, card: str) -> dict:
    """bench.py's NTT through the port's bench (ntt_stage: two forward
    transforms of canonical values from numpy's RandomState(1), the second
    timed), then inverse(forward(x)) == x bit for bit, a fresh engine's
    first forward (its tables built) and NTT_SAMPLES evaluations against a
    host Horner evaluation of the coefficients at w^i."""
    from go_snark_study_tpu_torch import bench
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops.ntt import NTTEngine

    n, ntt, K = 1 << log_n, fast.ntt, fast.Kr
    out = bench.ntt_stage(fast, n)
    x, y = out["x"], out["y"]
    assert torch.equal(ntt.inverse(y), x), f"[ladder] NTT 2^{log_n}: inverse(forward(x)) != x"
    fresh = NTTEngine(K)  # its first forward builds the step and twiddle tables on the host
    t0 = time.perf_counter()
    assert torch.equal(fresh.forward(x), y)
    torch.cuda.synchronize()
    t_fresh = time.perf_counter() - t0
    idx = sorted(random.Random(2).sample(range(n), NTT_SAMPLES))
    coeffs, got = K.unpack(x), K.unpack(y[:, idx].contiguous())
    w = ntt.root_of_unity(n)
    for i, g in zip(idx, got):
        wi, acc = pow(w, i, C.R), 0
        for c_ in reversed(coeffs):
            acc = (acc * wi + c_) % C.R
        assert acc == g, f"[ladder] NTT 2^{log_n}: evaluation {i} != the host's"
    print(f"[ladder] NTT 2^{log_n} forward: {out['ms']:.2f} ms (first {out['first_ms']:.2f} ms); inverse(forward) "
          f"bit for bit; a fresh engine's first forward, its tables built, {t_fresh:.3f} s; evaluations {idx} "
          f"equal the host's Horner values  ({card})")
    return dict(ms=out["ms"], first_ms=out["first_ms"], fresh_engine_first_s=t_fresh, samples=idx)


def ladder_modmul(torch, card: str) -> dict:
    """bench.py's Montgomery-product throughput through the port's bench
    (modmul_stage, at its chain and repetitions): a chain of products at
    2^20 lanes over fr_kernels(), repeated."""
    from go_snark_study_tpu_torch import bench
    from go_snark_study_tpu_torch.ops.fields import fr_kernels

    out = bench.modmul_stage(fr_kernels(), MODMUL_LANES)  # device=None: the card
    print(f"[ladder] Montgomery products at 2^{MODMUL_LANES.bit_length() - 1} lanes: {out['modmul_mps']:.1f} M/s  "
          f"({card})")
    return dict(modmul_mps=out["modmul_mps"])


def ladder_tier(torch, fast, log_n: int, card: str, phase: str = "ladder") -> dict:
    """One rung of bench.py's ladder through the port's bench (tier_stage,
    bench.py:513-576) on the phase's one engine: mul_chain_r1cs(2^log_n,
    seed=1), setup without host lists (its setup.* spans printed), a cold
    and a warm prove, verification; then a wrong public input, the warm
    prove's launches against the plans' prediction, peak device memory and
    the key's device bytes.  At the top tier, one prove more under
    torch.profiler and one with the prove.* spans (GOSNARK_MSM_PROFILE=1)."""
    from go_snark_study_tpu_torch import bench
    from go_snark_study_tpu_torch.models.groth16 import verify_proof

    tag = f"{phase} 2^{log_n}"
    t = bench.tier_stage(fast, log_n, setup_spans=True)
    r1cs, setup, proof, per = t["r1cs"], t["setup"], t["proof"], t["prove_counts"]
    pk, dpk = setup.pk, setup.pk._device
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    assert t["correct"], f"[{tag}] the proof does not verify"
    assert not verify_proof(setup.vk, proof, [publics[0] + 1]), f"[{tag}] a wrong public input verifies"
    k1_pred, lays = k1_per_prove(fast, dpk)
    k1 = {k: per[k] for k in K1_FORMS}
    k3_pred, k2_pred = k3_per_prove(dpk.n), k2_per_prove(dpk.n)
    assert per["K3"] == k3_pred, f"[{tag}] K3 launched {per['K3']} times in a prove, predicted {k3_pred}"
    assert t["warm_fallbacks"] or per["K2"] == k2_pred, \
        f"[{tag}] K2 launched {per['K2']} times in a prove, predicted {k2_pred}"
    if log_n == LADDER_TIERS[-1]:  # 2^20
        assert not t["warm_fallbacks"], f"[{tag}] a degeneracy flag fired in the warm prove"
        assert k1 == k1_pred, f"[{tag}] K1 launches per prove {k1}, the plans predict {k1_pred}"
    prof = host = None
    if log_n == LADDER_TIERS[-1]:  # where the time of a 2^20 prove goes: device (profiler), host phases (spans)
        prof = profile_prove(torch, fast, r1cs, pk, random.Random(4), tag, card)
        host = profiled(lambda: fast.prove(r1cs, pk, rng=random.Random(5)))
        print(f"[{tag}] spans of a warm prove (GOSNARK_MSM_PROFILE=1): {json.dumps(host)}")
    setup_rows = {k: round(v, 3) for k, v in t["setup_spans_s"].items()}
    print(f"[{tag}] {r1cs.n_constraints} constraints (mul_chain_r1cs {t['r1cs_s']:.2f} s): setup {t['setup_s']:.3f} s "
          f"({json.dumps(setup_rows)}), prove cold {t['prove_cold_s']:.3f} s, warm {t['prove_s']:.3f} s, verify "
          f"{t['verify_s']:.3f} s; verifies, a wrong public fails; proving key {t['pk_bytes'] / 1e6:.1f} MB on the "
          f"card, peak device memory {t['peak_bytes'] / 2**20:.1f} MiB; degeneracy re-runs {t['fallbacks']} (warm "
          f"prove {t['warm_fallbacks']})  ({card})")
    print(f"[{tag}] launches in the warm prove: K1 by form {json.dumps(k1)} (total {sum(k1.values())}; the plans "
          f"predict {json.dumps(k1_pred)}, total {sum(k1_pred.values())}), K2 {per['K2']} (predicted {k2_pred}), "
          f"K3 {per['K3']} (predicted {k3_pred}), K4 {per['K4']}  ({card})")
    for name, lay in lays.items():
        print(f"[{tag}]   MSM {name}: {lay['n']} lanes, {group_layout(lay)}")
    return dict(constraints=r1cs.n_constraints, r1cs_s=t["r1cs_s"], setup_s=t["setup_s"], setup_spans_s=setup_rows,
                prove_cold_s=t["prove_cold_s"], prove_s=t["prove_s"], verify_s=t["verify_s"], pk_bytes=t["pk_bytes"],
                peak_bytes=t["peak_bytes"], profile=prof, prove_phases=host,
                fallbacks=t["fallbacks"], prove_counts=per, k1_predicted=k1_pred, k2_predicted=k2_pred,
                k3_predicted=k3_pred,
                layouts={k: {f: v for f, v in lay.items()} for k, lay in lays.items()}, r1cs=r1cs, setup=setup)


def ladder_bridge(torch, fast, tier: dict, card: str) -> dict:
    """The host bridge on the 2^20 prove's own inputs (after the counts are
    read).  The card route: ``FastGroth16._prove_inputs`` (the witness
    crosses as bytes, relaid on the card; the H inputs from the SpMV on the
    card, in Montgomery form) and ``scalars_to_windows`` of the
    setup's ptau commit vector (the powers-of-tau ladder from the setup's
    toxic waste).  The Python route: the same values as Python ints, the
    Montgomery form taken on the host (``FieldKernels.pack_python``,
    ``ints_to_limbs_np``), the limbs copied to the card; beside it the JAX
    bridge's own route (``NativeField.pack_ints``: C++ Montgomery form,
    relaid on the host).  Every tensor must be equal across routes, bit for
    bit, and the commit vector's fixed-base commit must equal the key's
    ptau.  Each route is timed per 2^20 vector with host clocks around a
    synchronised call.  Returns the numbers and the card route's tensors."""
    from go_snark_study_tpu_torch import native
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops.curve_ops import tree_leaves
    from go_snark_study_tpu_torch.ops.limbs import bytes_to_limbs, ints_to_limbs_np
    from go_snark_study_tpu_torch.ops.msm import WINDOW_BITS, digits_from_limbs, scalars_to_windows

    assert native.available(), "the C++ host runtime (native/libgosnark_native.so) is not built"
    r1cs, setup = tier["r1cs"], tier["setup"]
    dpk = setup.pk._device
    n, r, Kr, dev = dpk.n, C.R, fast.Kr, fast.device

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the card route, as prove takes it
    (a_b, b_b, c_b, w_b), t_bytes = clock(r1cs._row_evals_bytes)
    (w_limbs, wp_limbs, h_in), t_inputs = clock(lambda: fast._prove_inputs(r1cs, dpk))
    card_pack = [clock(lambda: Kr.pack_bytes(v, lanes=n))[1] for v in (a_b, b_b, c_b)]
    _, t_w_card = clock(lambda: bytes_to_limbs(w_b, dev, dpk.m_pad))
    # the Python route and the JAX bridge's route, from the same values as ints
    evals, t_ints = clock(r1cs.row_evals)
    pad = lambda v, k: list(v) + [0] * (k - len(v))
    py_pack, nat_pack = [], []
    for got, v in zip(h_in, evals):
        want, t = clock(lambda: torch.from_numpy(Kr.pack_python(pad(v, n))).to(dev))
        assert torch.equal(got, want), "an H input: the card route differs from the Python route"
        py_pack.append(t)
        want, t = clock(lambda: torch.from_numpy(Kr.pack_np(pad(v, n))).to(dev))
        assert torch.equal(got, want), "an H input: the card route differs from NativeField.pack_ints"
        nat_pack.append(t)
    w = [x % r for x in r1cs.witness]
    lo = dpk.lo
    want_w, t_w_py = clock(lambda: torch.from_numpy(ints_to_limbs_np(pad(w, dpk.m_pad))).to(dev))
    want_wp = torch.from_numpy(ints_to_limbs_np(pad(w[lo:], dpk.mp_pad))).to(dev)
    assert torch.equal(w_limbs, want_w), "w_limbs: the card route differs from the Python route"
    assert torch.equal(wp_limbs, want_wp), "wp_limbs: the card route differs from the Python route"
    # one setup commit vector: ptau's scalars, tau^i Z(tau)/delta for i < n
    tox = setup.toxic
    ztd = (pow(tox.t, n, r) - 1) * pow(tox.kdelta, -1, r) % r
    ladder, acc = [], ztd
    for _ in range(n):
        ladder.append(acc)
        acc = acc * tox.t % r
    scs = pad(ladder, dpk.n_pad)
    win, t_commit_card = clock(lambda: scalars_to_windows(scs, r, dev))
    want, t_commit_py = clock(lambda: digits_from_limbs(torch.from_numpy(ints_to_limbs_np(scs)).to(dev), WINDOW_BITS))
    assert torch.equal(win, want), "the ptau commit vector: the card route differs from the Python route"
    aff = fast.g1b.to_affine(fast.fb_g1.batch_mul_device(win))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(aff), tree_leaves(dpk.ptau))), \
        "the ptau commit vector does not commit to the key's ptau"
    out = dict(bridge_row_evals_bytes_s=t_bytes, bridge_row_evals_ints_s=t_ints, bridge_prove_inputs_s=t_inputs,
               bridge_pack_s=card_pack, bridge_python_pack_s=py_pack, bridge_native_pack_s=nat_pack,
               bridge_witness_s=dict(card=t_w_card, python=t_w_py),
               bridge_commit_s=dict(card=t_commit_card, python=t_commit_py))
    print(f"[ladder] host bridge at 2^{n.bit_length() - 1}, bit for bit equal across routes (the three H inputs, "
          f"w_limbs, wp_limbs, the ptau commit vector, which commits to the key's ptau): "
          f"{json.dumps(out)}  ({card})")
    return dict(out, inputs=(w_limbs, wp_limbs, h_in))


def held_row(torch, held: list, kernel: str, shape: str, got, want, arity: int = 0, flags: bool = False):
    """Compare a kernel's result with its plain version's (with their flags
    when ``flags``), record it in ``held`` and raise on a difference;
    returns the plain result (without its flag)."""
    from go_snark_study_tpu_torch.ops import point_add as pa

    if flags:
        (got, gbad), (want, wbad) = got, want
        flags_equal = bool(gbad) == bool(wbad)
    else:
        flags_equal = True
    gl = pa._leaves(got, arity) if arity else [got]
    wl = pa._leaves(want, arity) if arity else [want]
    equal = all(torch.equal(g, w) for g, w in zip(gl, wl))
    held.append(dict(kernel=kernel, shape=shape, equal=equal, flags_equal=flags_equal,
                     max_abs_err=max_abs_err(torch, gl, wl)))
    assert equal and flags_equal, f"[ladder] {kernel} ({shape}): kernel != plain {held[-1]}"
    return want


def time_site(torch, clock_hz, kernel: str, site: str, shape: str, fn, names, reps: int, nbytes: float,
              ops: float, per_call: int, **extra) -> dict:
    """One timing row of the ladder path: ``fn``'s device ms per launch from
    torch.profiler (from CUDA events around a loop of calls, marked so, where
    three profiling sessions record none of its launches), its wrapper ms and
    its bound; ``plain_ms`` is filled in by the caller."""
    wrapper = cuda_ms(torch, fn, reps, warm=1)
    try:
        dev, launches = device_ms(torch, fn, reps, names, warm=0)
        timing = "profiler"
    except RuntimeError:
        dev, launches, timing = wrapper / per_call, per_call, "cuda events"
    bnd, by = bound_ms(nbytes / per_call, ops / per_call, clock_hz)
    return dict(kernel=kernel, site=site, shape=shape, ms=dev, device_ms=dev, timing=timing,
                launches_per_call=launches, wrapper_ms=wrapper, plain_ms=None, bound_ms=bnd, bound_by=by,
                max_abs_err=0, **extra)


def plain_call(torch, fn):
    """(result, ms) of one call of a plain version on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def ladder_vs_plain(torch, clock_hz, fast, tier: dict, inputs, card: str):
    """Every kernel of the ladder path on the 2^20 prove's own shapes and
    inputs (after the counts are read): K1's apply, merge-scan and reduce
    forms on the last, zero-padded window group of the witness plan, in G1
    (At) and in G2 (B2 on that same G1 plan), the reduce on the buckets of
    every group, as the prove reduces them; K1's per-lane jadd on the
    fixed-base commit's second window step; K2 on the H pipeline's first
    coset product and K3 on its first three leaves.  Each is timed on the
    card beside its bound first; then each is held against its plain
    version, bit for bit with equal flags (the complete forms too where a
    flag fired).  Beside them, to_affine and to_affine_tiled in turns on the
    setup commit's width.  Returns (held, sites, the affine timings)."""
    import go_snark_study_tpu_torch.ops.ntt as ntt_mod
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops import mont_mul as mm
    from go_snark_study_tpu_torch.ops import msm_kernels as mk
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.ops.curve_ops import tree_leaves, tree_map
    from go_snark_study_tpu_torch.ops.fixed_base import DIGITS
    from go_snark_study_tpu_torch.ops.msm import WINDOW_BITS, MSMEngine, bucket_count, digits_from_limbs
    from go_snark_study_tpu_torch.profiling import kernel_cost

    dpk = tier["setup"].pk._device
    held, sites, plain_ms = [], [], {}
    w_limbs, _, h_in = inputs  # the prove's own (FastGroth16._prove_inputs)
    eng = fast.msm_g1
    c = eng.window_bits_for(dpk.m_pad)
    lay = eng.layout(dpk.m_pad, c)
    plans = eng.make_plans(w_limbs, c)
    assert (plans["wg"], plans["wpad"], len(plans["plans"])) == (lay["wg"], lay["wpad"], lay["groups"]), lay
    last = plans["plans"][-1]
    sdig = last["comp_dig"]
    m_buckets, d_chunk = bucket_count(c)
    groups = ((1, dpk.at), (2, dpk.b2))

    def buckets(pts, arity, complete, scanned_last):
        """Every group's buckets as the prove reduces them: the groups before
        the last through the kernels, then the last group's from ``scanned_last``."""
        parts = []
        for plan in plans["plans"][:-1]:
            part, _ = mk.seg_scan(mk.apply(pts, plan, arity, complete)[0], plan["comp_dig"], arity, complete)
            parts.append(MSMEngine._runs_to_buckets(part, plan["comp_dig"], m_buckets))
        parts.append(MSMEngine._runs_to_buckets(scanned_last, sdig, m_buckets))
        return tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)

    # the inputs of K1's per-lane jadd, K2 and K3 on this prove's path
    windows = digits_from_limbs(w_limbs, WINDOW_BITS)
    steps = {}
    for arity, fb, bg in ((1, fast.fb_g1, fast.g1b), (2, fast.fb_g2, fast.g2b)):
        acc = bg.zeros(dpk.m_pad)
        for w_ in range(2):
            idx = windows[w_].long() + w_ * DIGITS
            pt = tree_map(lambda t: t.index_select(1, idx), fb._table)
            steps[arity] = (acc, pt)
            acc = bg.jadd(acc, pt)
    # to_affine against to_affine_tiled on the setup commit's width, in turns
    affine = {}
    for arity, fb, bg in ((1, fast.fb_g1, fast.g1b), (2, fast.fb_g2, fast.g2b)):
        jac = fb.batch_mul_device(windows)
        out, secs, peak = {}, {"to_affine": [], "to_affine_tiled": []}, {}
        for name in ("to_affine", "to_affine_tiled", "to_affine_tiled", "to_affine"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out[name] = getattr(bg, name)(jac)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            peak[name] = torch.cuda.max_memory_allocated() - base
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out["to_affine"]), tree_leaves(out["to_affine_tiled"])))
        affine[f"G{arity}"] = dict(lanes=dpk.m_pad, s=secs, peak_bytes=peak)
        print(f"[ladder] G{arity} to_affine and to_affine_tiled at {dpk.m_pad} lanes, in turns: {json.dumps(secs)} s; "
              f"peak bytes above the input {json.dumps(peak)}; bit for bit equal  ({card})")
        del jac, out
    n = dpk.n
    leaves, coset = [], []
    small_ntt, coset_shift = ntt_mod.small_ntt, fast.ntt.coset_shift

    def rec_small(x, tw):
        if len(leaves) < 3:
            leaves.append((x.clone(), tw))
        return small_ntt(x, tw)

    def rec_shift(x, g=5, inverse=False, powers=None):
        if not coset:
            coset.append((x.clone(), powers))
        return coset_shift(x, g, inverse, powers)

    ntt_mod.small_ntt, fast.ntt.coset_shift = rec_small, rec_shift
    try:
        fast._get_h_jit(n, dpk.n_pad)(*h_in, *fast._ntt_args(n))
    finally:
        ntt_mod.small_ntt = small_ntt
        del fast.ntt.coset_shift
    log_n = n.bit_length() - 1

    # 1. times, the kernels alone (no plain version has run yet)
    for arity, pts in groups:
        comp, _ = mk.apply(pts, last, arity, False)
        scanned, _ = mk.seg_scan(comp, sdig, arity, False)
        bk = buckets(pts, arity, False, scanned)
        calls = {"apply": lambda: mk.apply(pts, last, arity, False),
                 "seg-scan": lambda: mk.seg_scan(comp, sdig, arity, False),
                 "reduce-1": lambda: mk.reduce(bk, d_chunk, arity, False)}
        calls["reduce-2"] = calls["reduce-1"]
        for site, kern, names, nbytes, ops, shape, per_call in msm_form_costs(torch, last, dpk.m_pad, arity, bk,
                                                                              d_chunk):
            sites.append(time_site(torch, clock_hz, kern.name, site, shape, calls[site], names,
                                   3 if site in ("apply", "seg-scan") else 5, nbytes, ops, per_call,
                                   group=f"G{arity}", c=c))
        acc, pt = steps[arity]
        cost = kernel_cost("point_add", dpk.m_pad, group=arity)
        sites.append(time_site(torch, clock_hz, "K1 point_add", "per-lane jadd",
                               f"{dpk.m_pad} lanes, fixed-base window step 1", lambda: pa.point_add("jadd", arity, acc, pt),
                               ("point_add_kernel",), 10, cost["bytes"], cost["int32_ops"], 1, group=f"G{arity}"))
    x, powers = coset[0]
    cost = kernel_cost("mont_mul", n)
    sites.append(time_site(torch, clock_hz, "K2 mont_mul", "coset product", f"(8, {n}) Fr",
                           lambda: mm.mont_mul(x, powers, C.R), ("mont_mul_kernel",), 50, cost["bytes"],
                           cost["int32_ops"], 1))
    for k, (x, tw) in enumerate(leaves):
        g, L = x.shape[1], x.shape[2]
        cost = kernel_cost("small_ntt", L, g=g)
        sites.append(time_site(torch, clock_hz, "K3 small_ntt", f"2^{log_n} leaf {k + 1}", f"(8, {g}, {L})",
                               lambda: nk.small_ntt(x, tw), ("small_ntt_kernel",), 50, cost["bytes"],
                               cost["int32_ops"], 1, launch=nk.small_ntt_shape(g, L)))

    # 2. each kernel against its plain version
    t0 = time.perf_counter()
    for complete in (False, True) if tier["fallbacks"] else (False,):
        mode = "complete" if complete else "incomplete"
        for arity, pts in groups:
            tag = f"G{arity} {mode}, last group of {lay['wg']} windows ({lay['wpad']} zero)"
            want, ms = plain_call(torch, lambda: mk.apply_plain(pts, last, arity, complete))
            plain_ms[("apply", arity, complete)] = ms
            comp = held_row(torch, held, "K1 apply", tag, mk.apply(pts, last, arity, complete), want, arity, True)
            want, ms = plain_call(torch, lambda: mk.seg_scan_plain(comp, sdig, arity, complete))
            plain_ms[("seg-scan", arity, complete)] = ms
            scanned = held_row(torch, held, "K1 seg-scan", tag, mk.seg_scan(comp, sdig, arity, complete), want,
                               arity, True)
            bk = buckets(pts, arity, complete, scanned)
            want, ms = plain_call(torch, lambda: mk.reduce_plain(bk, d_chunk, arity, complete))
            plain_ms[("reduce-1", arity, complete)] = ms
            held_row(torch, held, "K1 reduce", f"G{arity} {mode}, {lay['w'] + lay['wpad']} windows x {m_buckets} "
                     f"buckets", mk.reduce(bk, d_chunk, arity, complete), want, arity, True)
    t_forms = time.perf_counter() - t0
    for arity, _ in groups:
        acc, pt = steps[arity]
        want, plain_ms[("per-lane jadd", arity)] = plain_call(torch, lambda: pa.point_add_plain("jadd", arity, acc, pt))
        held_row(torch, held, "K1 jadd", f"G{arity} {dpk.m_pad} lanes, fixed-base window step 1",
                 pa.point_add("jadd", arity, acc, pt), want, arity)
    x, powers = coset[0]
    want, plain_ms[("coset product",)] = plain_call(torch, lambda: mm.mont_mul_plain(x, powers, C.R))
    held_row(torch, held, "K2", f"(8, {n}) Fr, the H pipeline's first coset product", mm.mont_mul(x, powers, C.R),
             want)
    for k, (x, tw) in enumerate(leaves):
        want, plain_ms[(f"2^{log_n} leaf {k + 1}",)] = plain_call(torch, lambda: nk.small_ntt_plain(x, tw))
        held_row(torch, held, "K3", f"(8, {x.shape[1]}, {x.shape[2]}), leaf {k + 1} of the first 2^{log_n} transform",
                 nk.small_ntt(x, tw), want)
    for row in sites:
        arity = int(row["group"][1]) if "group" in row else None
        key = (row["site"], arity, False) if row["site"] in ("apply", "seg-scan", "reduce-1") else \
            (row["site"], arity) if arity else (row["site"],)
        row["plain_ms"] = plain_ms.get(key)
        plain = f", plain {row['plain_ms']:.1f} ms" if row["plain_ms"] is not None else ""
        print(f"[ladder] {row['kernel']} {row['site']} {row.get('group', '')} ({row['shape']}): device "
              f"{row['ms']:.5f} ms/launch ({row['timing']}, x{row['launches_per_call']:g} per call), wrapper "
              f"{row['wrapper_ms']:.4f} ms{plain}, bound {row['bound_ms']:.6f} ms ({row['bound_by']})  ({card})")
    print(f"[ladder] held against the plain versions, bit for bit with equal flags, on the 2^{log_n} prove's "
          f"inputs: " + "; ".join(f"{h['kernel']} {h['shape']}" for h in held)
          + f" (K1 forms {t_forms:.1f} s)  ({card})")
    return held, sites, affine


def run_ladder(torch, clock_hz, card: str) -> dict:
    """The ladder phase (see the module docstring).  The counts are set to 0
    before the warmup and read after the 2^21 MSM; the plain comparisons
    come after."""
    from go_snark_study_tpu_torch import bench
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.profiling import launch_counts, reset_counts

    secs = {}

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        return out

    reset_counts()
    fast = FastGroth16()  # device=None: the card; one engine for the phase, as bench.py:319-322
    warm = step("warmup", lambda: fast.warmup(families=("big",), domains=tuple(1 << k for k in LADDER_TIERS),
                                              g2=True, fixed_base=True))
    print(f"[ladder] warmup {secs['warmup']:.2f} s: {json.dumps({k: round(v, 3) for k, v in warm.items()})}  ({card})")
    rng = random.Random(LADDER_SEED)
    serial = bench.serial_baseline(rng)  # bench.py's first 8 draws: the MSMs get bench.py's inputs
    msm = {LADDER_MSM_LOGS[0]: step(f"msm 2^{LADDER_MSM_LOGS[0]}",
                                    lambda: ladder_msm(torch, fast, LADDER_MSM_LOGS[0], rng, 3, card))}
    ntt = step(f"ntt 2^{LADDER_NTT_LOG}", lambda: ladder_ntt(torch, fast, LADDER_NTT_LOG, card))
    modmul = step("modmul", lambda: ladder_modmul(torch, card))
    tiers = {}
    for log_n in LADDER_TIERS:
        tiers[log_n] = step(f"tier 2^{log_n}", lambda: ladder_tier(torch, fast, log_n, card))
        if log_n != LADDER_TIERS[-1]:  # keep the last tier's key for the plain comparisons
            del tiers[log_n]["setup"], tiers[log_n]["r1cs"]
    msm[LADDER_MSM_LOGS[1]], watch = step(
        f"msm 2^{LADDER_MSM_LOGS[1]}",
        lambda: watched_msm(torch, fast, lambda: ladder_msm(torch, fast, LADDER_MSM_LOGS[1], rng, 1, card)))
    msm[LADDER_MSM_LOGS[1]]["watch"] = watch
    counts = launch_counts()
    for k in K1_FORMS + ("K2", "K3"):
        assert counts[k] > 0, f"{k} not launched on the ladder path"
    top = tiers[LADDER_TIERS[-1]]
    bridge = step("host bridge", lambda: ladder_bridge(torch, fast, top, card))
    inputs = bridge.pop("inputs")
    held, sites, affine = step("held against plain",
                               lambda: ladder_vs_plain(torch, clock_hz, fast, top, inputs, card))
    del inputs
    m20, m21 = msm[LADDER_MSM_LOGS[0]], msm[LADDER_MSM_LOGS[1]]
    by_residency = step("msm 2^21 by residency", lambda: msm21_by_residency(torch, fast, rng, m21, top, card))
    line = {"card": card, f"msm_g1_points_per_sec_2^{LADDER_MSM_LOGS[0]}": m20["points_per_sec"],
            f"msm_2^{LADDER_MSM_LOGS[0]}_ms": m20["ms"], f"ntt_2^{LADDER_NTT_LOG}_ms": ntt["ms"],
            "modmul_mps": modmul["modmul_mps"], "serial_pts_per_s": serial["serial_pts_per_s"]}
    for log_n, t in tiers.items():
        line[f"groth16_setup_2^{log_n}_s"] = t["setup_s"]
        line[f"groth16_prove_2^{log_n}_s"] = t["prove_s"]
        line[f"groth16_prove_cold_2^{log_n}_s"] = t["prove_cold_s"]
        line[f"pk_hbm_2^{log_n}_mb"] = t["pk_bytes"] / 1e6
    line.update({f"msm_2^{LADDER_MSM_LOGS[1]}_ms": m21["ms"],
                 f"msm_2^{LADDER_MSM_LOGS[1]}_pts_per_sec": m21["points_per_sec"],
                 "msm_fallback_hits": m20["fallback_hits"] + m21["fallback_hits"],
                 "prove_fallback_hits": sum(t["fallbacks"] for t in tiers.values()),
                 **bridge, f"prove_phases_2^{LADDER_TIERS[-1]}": top["prove_phases"],
                 f"k2_per_prove_2^{LADDER_TIERS[-1]}": top["prove_counts"]["K2"],
                 f"msm_2^{LADDER_MSM_LOGS[1]}_by_residency": by_residency,
                 "warmup_steps_s": warm, "step_s": secs, "msm": msm, "ntt": ntt, "tiers": tiers,
                 "launches": counts, "held_against_plain": held, "sites": sites, "affine": affine})
    print(f"[ladder] seconds by step: {json.dumps({k: round(v, 1) for k, v in secs.items()})}  ({card})")
    print(json.dumps({"ladder": line}))
    return dict(counts=counts, sites=sites)


def chunked_engines(fast):
    """The JAX package's accelerator configuration of ``fast``'s engines:
    (G1 with both chunk families, G2 with the big one only)."""
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.ops.msm import MSMEngine

    bn = fast.ctx.bn
    return (MSMEngine(fast.g1b, bn.g1, C.R, chunk_lanes=BIG_CHUNK, small_chunk_lanes=SMALL_CHUNK),
            MSMEngine(fast.g2b, bn.g2, C.R, chunk_lanes=BIG_CHUNK, small_chunk_lanes=0))


def same_proof(bn, a, b) -> bool:
    return bn.g1.equal(a.pi_a, b.pi_a) and bn.g2.equal(a.pi_b, b.pi_b) and bn.g1.equal(a.pi_c, b.pi_c)


def chunked_turns(torch, fast, tier: dict, engines: dict, card: str) -> dict:
    """The 2^20 key proved by the chunked and the unchunked (default)
    engines in turns (chunked, unchunked, unchunked, chunked), each from
    random.Random(3), the warm prove's rng state: the four proofs must be
    equal as group elements.  Then one unchunked prove under the profiler."""
    bn = fast.ctx.bn
    r1cs, pk = tier["r1cs"], tier["setup"].pk
    secs, proofs = {"chunked": [], "unchunked": []}, []
    for name in ("chunked", "unchunked", "unchunked", "chunked"):
        fast.msm_g1, fast.msm_g2 = engines[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs.append(fast.prove(r1cs, pk, rng=random.Random(3)))
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    assert all(same_proof(bn, proofs[0], p) for p in proofs[1:]), \
        "[chunked 2^20] the chunked proof is not the unchunked engines' proof"
    fast.msm_g1, fast.msm_g2 = engines["unchunked"]
    prof = profile_prove(torch, fast, r1cs, pk, random.Random(4), "chunked 2^20, unchunked engines", card)
    fast.msm_g1, fast.msm_g2 = engines["chunked"]
    print(f"[chunked 2^20] chunked and unchunked engines on one key, in turns: {json.dumps(secs)} s; "
          f"the four proofs are equal  ({card})")
    return dict(prove_s=secs, unchunked_profile=prof)


def chunked_vs_plain(torch, clock_hz, fast, tier: dict, card: str):
    """K1 at the chunk shapes of the 2^20 prove's own inputs (after the
    counts are read): the apply and merge-scan forms on the last,
    zero-padded chunk of the witness plan, in G1 (At) and G2 (B2 on that
    plan); the per-lane jadd_f on the first two chunks' buckets (the
    cross-chunk add), G1 and G2; the reduce on the buckets of all chunks
    added together, G1.  Each is timed on the card beside its bound first,
    then held against its plain version, bit for bit with equal flags.
    Returns (held, sites)."""
    from go_snark_study_tpu_torch.ops import msm_kernels as mk
    from go_snark_study_tpu_torch.ops import point_add as pa
    from go_snark_study_tpu_torch.ops.curve_ops import tree_map
    from go_snark_study_tpu_torch.ops.msm import bucket_count
    from go_snark_study_tpu_torch.profiling import kernel_cost

    dpk = tier["setup"].pk._device
    w_limbs = fast._prove_inputs(tier["r1cs"], dpk)[0]
    eng = fast.msm_g1
    c = eng.window_bits_for(dpk.m_pad)
    lay = eng.layout(dpk.m_pad, c)
    plans = eng.make_plans(w_limbs, c)
    assert plans["mode"] == "chunk" and len(plans["chunks"]) == lay["chunks"] and lay["groups"] == 1, lay
    span, last = plans["span"], plans["chunks"][-1][0]
    sdig = last["comp_dig"]
    m_buckets, d_chunk = bucket_count(c)
    engs = {1: (fast.msm_g1, dpk.at), 2: (fast.msm_g2, dpk.b2)}
    chunk = lambda pts, ci: tree_map(lambda t: eng._chunk_of(t, ci * span, span), pts)

    def buckets(arity, ci):
        e, pts = engs[arity]
        return e._apply_impl(chunk(pts, ci), plans["chunks"][ci][0], c)[0]

    pair = {a: (buckets(a, 0), buckets(a, 1)) for a in (1, 2)}
    acc = buckets(1, 0)
    for ci in range(1, len(plans["chunks"])):
        acc, _ = eng._badd(acc, buckets(1, ci))
    lasts = {a: chunk(engs[a][1], len(plans["chunks"]) - 1) for a in (1, 2)}
    held, sites, plain_ms = [], [], {}
    shape_tag = f"last chunk of {lay['chunks']} ({span} lanes, {dpk.m + span - dpk.m_pad} live)"

    # 1. times, the kernels alone
    for arity in (1, 2):
        pts = lasts[arity]
        comp, _ = mk.apply(pts, last, arity, False)
        calls = {"apply": lambda: mk.apply(pts, last, arity, False),
                 "seg-scan": lambda: mk.seg_scan(comp, sdig, arity, False),
                 "reduce-1": lambda: mk.reduce(acc, d_chunk, 1, False)}
        calls["reduce-2"] = calls["reduce-1"]
        bk = acc if arity == 1 else pair[2][0]
        for site, kern, names, nbytes, ops, shape, per_call in msm_form_costs(torch, last, span, arity, bk, d_chunk):
            if site.startswith("reduce") and arity == 2:
                continue
            sites.append(time_site(torch, clock_hz, kern.name, f"chunk {site}", shape, calls[site], names,
                                   3 if site != "seg-scan" else 5, nbytes, ops, per_call, group=f"G{arity}", c=c))
        b0, b1 = pair[arity]
        lanes = pa._leaves(b0, arity)[0].numel() // 8
        cost = kernel_cost("point_add", lanes, group=arity)
        sites.append(time_site(torch, clock_hz, "K1 point_add", "cross-chunk jadd_f",
                               f"(8, {lay['w']}, {m_buckets}) buckets, {lanes} lanes",
                               lambda: pa.point_add("jadd_f", arity, b0, b1), ("point_add_kernel",), 10,
                               cost["bytes"], cost["int32_ops"], 1, group=f"G{arity}", c=c))

    # 2. each kernel against its plain version
    t0 = time.perf_counter()
    for arity in (1, 2):
        pts = lasts[arity]
        tag = f"G{arity}, {shape_tag}"
        want, plain_ms[("chunk apply", arity)] = plain_call(torch, lambda: mk.apply_plain(pts, last, arity, False))
        comp = held_row(torch, held, "K1 apply", tag, mk.apply(pts, last, arity, False), want, arity, True)
        want, plain_ms[("chunk seg-scan", arity)] = plain_call(torch, lambda: mk.seg_scan_plain(comp, sdig, arity,
                                                                                                 False))
        held_row(torch, held, "K1 seg-scan", tag, mk.seg_scan(comp, sdig, arity, False), want, arity, True)
        b0, b1 = pair[arity]
        any_flag = lambda r: (r[0], r[1].any())  # the lane flags, as the engine reads them
        want, plain_ms[("cross-chunk jadd_f", arity)] = plain_call(torch, lambda: pa.point_add_plain("jadd_f", arity,
                                                                                                      b0, b1))
        got = pa.point_add("jadd_f", arity, b0, b1)
        assert torch.equal(got[1], want[1]), f"[chunked] K1 jadd_f G{arity}: the lane flags differ from the plain's"
        held_row(torch, held, "K1 jadd_f", f"G{arity}, chunk 0 + chunk 1 buckets", any_flag(got), any_flag(want),
                 arity, True)
    want, plain_ms[("chunk reduce-1", 1)] = plain_call(torch, lambda: mk.reduce_plain(acc, d_chunk, 1, False))
    held_row(torch, held, "K1 reduce", f"G1, the {lay['chunks']} chunks' buckets added, {lay['w']} windows x "
             f"{m_buckets} buckets", mk.reduce(acc, d_chunk, 1, False), want, 1, True)
    t_plain = time.perf_counter() - t0
    for row in sites:
        row["plain_ms"] = plain_ms.get((row["site"], int(row["group"][1])))
        plain = f", plain {row['plain_ms']:.1f} ms" if row["plain_ms"] is not None else ""
        print(f"[chunked] {row['kernel']} {row['site']} {row['group']} ({row['shape']}): device {row['ms']:.5f} "
              f"ms/launch ({row['timing']}, x{row['launches_per_call']:g} per call), wrapper {row['wrapper_ms']:.4f} "
              f"ms{plain}, bound {row['bound_ms']:.6f} ms ({row['bound_by']})  ({card})")
    print(f"[chunked] held against the plain versions, bit for bit with equal flags, on the 2^20 prove's inputs: "
          + "; ".join(f"{h['kernel']} {h['shape']}" for h in held) + f" (plain {t_plain:.1f} s)  ({card})")
    return held, sites


def run_chunked(torch, clock_hz, card: str) -> dict:
    """The chunked phase (see the module docstring).  The counts are set to
    0 before the warmup and read after the 2^21 MSM; the turns with the
    unchunked engines and the plain comparisons come after."""
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.profiling import launch_counts, reset_counts

    secs = {}

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        return out

    fast = FastGroth16()  # device=None: the card
    engines = {"unchunked": (fast.msm_g1, fast.msm_g2), "chunked": chunked_engines(fast)}
    fast.msm_g1, fast.msm_g2 = engines["chunked"]
    reset_counts()
    warm = step("warmup", lambda: fast.warmup(families=("big", "small"), domains=tuple(1 << k for k in CHUNK_TIERS),
                                              g2=True, fixed_base=True))
    print(f"[chunked] warmup {secs['warmup']:.2f} s: {json.dumps({k: round(v, 4) for k, v in warm.items()})}  "
          f"({card})")
    tiers = {}
    for log_n in CHUNK_TIERS:
        t = tiers[log_n] = step(f"tier 2^{log_n}", lambda: ladder_tier(torch, fast, log_n, card, phase="chunked"))
        k1 = {k: t["prove_counts"][k] for k in K1_FORMS}
        assert t["fallbacks"] or k1 == t["k1_predicted"], \
            f"[chunked 2^{log_n}] K1 launches per prove {k1}, the plans predict {t['k1_predicted']}"
        if log_n != CHUNK_TIERS[-1]:
            del t["setup"], t["r1cs"]
    t14, t20 = tiers[CHUNK_TIERS[0]], tiers[CHUNK_TIERS[-1]]
    lw = t14["layouts"]
    c_small, c_big = fast.msm_g1.window_bits_for(SMALL_CHUNK), fast.msm_g2.window_bits_for(BIG_CHUNK)
    assert (lw["at"]["mode"], lw["at"]["c"], lw["at"]["span"], lw["at"]["chunks"]) == ("chunk", c_small, SMALL_CHUNK,
                                                                                         2), lw
    assert (lw["b2"]["c"], lw["b2"]["span"]) == (c_big, BIG_CHUNK) and c_big != c_small, lw  # G2 on its own plan
    dpk = t20["setup"].pk._device
    assert dpk.m_pad == 9 * BIG_CHUNK and all(t.shape[-1] == dpk.m_pad for k, t in device_pk_leaves(dpk).items()
                                              if k.split(".")[0] in ("at", "b1", "b2")), dpk.m_pad
    assert t20["prove_counts"]["K1"] == t20["k1_predicted"]["K1"] == 39, t20["prove_counts"]
    rng = random.Random(LADDER_SEED)
    msm = {}
    for log_n, runs in zip(CHUNK_MSM_LOGS, (3, 1)):
        msm[log_n] = step(f"msm 2^{log_n}", lambda: ladder_msm(torch, fast, log_n, rng, runs, card, phase="chunked"))
        assert msm[log_n]["layout"]["mode"] == "chunk" and msm[log_n]["layout"]["chunks"] == (1 << log_n) // BIG_CHUNK
    counts = launch_counts()
    for k in K1_FORMS + ("K2", "K3"):
        assert counts[k] > 0, f"{k} not launched on the chunked path"
    turns = step("turns", lambda: chunked_turns(torch, fast, t20, engines, card))
    held, sites = step("held against plain", lambda: chunked_vs_plain(torch, clock_hz, fast, t20, card))
    del t20["setup"], t20["r1cs"]
    prof_c, prof_u = t20["profile"], turns["unchunked_profile"]
    apply_ms = {name: dict(per_prove=p["k1_ms"].get("msm_apply"), launches=p["k1_launches"].get("msm_apply"),
                           per_launch=p["k1_ms"].get("msm_apply", 0) / max(1, p["k1_launches"].get("msm_apply", 0)))
                for name, p in (("chunked", prof_c), ("unchunked", prof_u))}
    lo, hi = (f"2^{k}" for k in CHUNK_TIERS)
    line = {"card": card, "warmup_steps_s": warm,
            f"prove_{lo}_s": t14["prove_s"], f"prove_cold_{lo}_s": t14["prove_cold_s"],
            f"prove_{hi}_s": t20["prove_s"], f"prove_cold_{hi}_s": t20["prove_cold_s"],
            f"prove_{hi}_turns_s": turns["prove_s"],
            f"busy_share_{hi}": {"chunked": prof_c["busy_s"] / prof_c["wall_s"],
                                 "unchunked": prof_u["busy_s"] / prof_u["wall_s"]},
            f"device_launches_{hi}": {"chunked": prof_c["launches"], "unchunked": prof_u["launches"]},
            f"k1_apply_ms_{hi}": apply_ms, **{f"msm_2^{k}_ms": msm[k]["ms"] for k in CHUNK_MSM_LOGS},
            f"peak_bytes_{hi}": t20["peak_bytes"], f"pk_bytes_{hi}": t20["pk_bytes"],
            f"pk_bytes_{lo}": t14["pk_bytes"], "launches": counts, "tiers": tiers, "msm": msm,
            "held_against_plain": held, "sites": sites, "step_s": secs}
    print(f"[chunked] K1 apply in a profiled {hi} prove: {json.dumps(apply_ms)}  ({card})")
    print(f"[chunked] seconds by step: {json.dumps({k: round(v, 1) for k, v in secs.items()})}  ({card})")
    print(json.dumps({"chunked": line}))
    return dict(counts=counts, sites=sites)


def run_sharded(torch, card: str, paths: dict):
    """The sharded phase (see the module docstring).  Every rank's failure
    raises here, through run_ranks."""
    from go_snark_study_tpu_torch import _build
    from go_snark_study_tpu_torch.parallel import checks
    from go_snark_study_tpu_torch.parallel.launch import run_ranks
    from go_snark_study_tpu_torch.parallel.scaling import run as scaling_run
    from go_snark_study_tpu_torch.profiling import kernel_objects

    _build.build_all()  # here, before any spawn: the ranks load build/torch_kernels/
    counts = {name: 0 for name in kernel_objects()}
    line = dict(card=card, runs={})
    for label, backend, world, layout, log_n, checks_ntt, shape_22 in SHARDED_RUNS:
        t0 = time.perf_counter()
        ranks = run_ranks(checks.card_run, world, backend, "cuda", log_n, layout, None,
                          checks_ntt, checks_ntt, shape_22)
        wall = time.perf_counter() - t0
        for r, out in enumerate(ranks):
            tag = f"[sharded {label} 2^{log_n}] rank {r} on {out['device']}"
            assert out["equal"], f"{tag}: prove_sharded's proof is not FastGroth16.prove's"
            assert out["verifies"], f"{tag}: the sharded proof does not verify"
            assert out["wrong_public_fails"], f"{tag}: the sharded proof verifies with a wrong public"
            assert out["proof"] == ranks[0]["proof"], f"{tag}: not rank 0's proof"
            if checks_ntt:
                ntt = out["ntt"][layout]
                assert ntt["matches_single"], f"{tag}: FourStepNTT.forward != NTTEngine.forward permuted"
                assert ntt["roundtrip"], f"{tag}: FourStepNTT inverse(forward(x)) != x"
                assert out["step"]["h_shape"] == (8, 1 << log_n), f"{tag}: prove step {out['step']}"
            if shape_22:
                assert out["shape_22"]["ok"], f"{tag}: {out['shape_22']}"
            for name, n in out["counts"].items():
                counts[name] += n
            for h in out["held"]:
                assert h["equal"] and h["flags_equal"], f"{tag}: {h['kernel']} ({h['shape']}): kernel != plain {h}"
            if out["held"]:
                print(f"{tag}: kernel == plain, bit for bit with equal flags, on this path's own inputs: "
                      + "; ".join(f"{h['kernel']} {h['shape']}" for h in out["held"]) + f"  ({card})")
            print(f"{tag}: setup {out['setup_s']:.3f} s, prove_sharded {out['sharded_prove_s'][0]:.3f} / "
                  f"{out['sharded_prove_s'][1]:.3f} s, FastGroth16.prove {out['single_prove_s'][0]:.3f} / "
                  f"{out['single_prove_s'][1]:.3f} s (first / second); equal proofs, verifies, wrong public "
                  f"fails; degeneracy re-runs {out['fallbacks']}  ({card})")
            if checks_ntt:
                print(f"{tag}: FourStepNTT 2^{log_n} forward matches the single-device NTT permuted, inverse "
                      f"round-trips, forward {ntt['forward_s'][0]:.4f} / {ntt['forward_s'][1]:.4f} s (first / second); "
                      f"prove step {out['step']['seconds']:.3f} s "
                      f"({card})")
        line["runs"][label] = dict(
            backend=backend, ranks=world, layout=layout, constraints=1 << log_n, wall_s=wall,
            setup_s=[o["setup_s"] for o in ranks], sharded_prove_s=[o["sharded_prove_s"] for o in ranks],
            single_prove_s=[o["single_prove_s"] for o in ranks], fallbacks=[o["fallbacks"] for o in ranks],
            devices=[o["device"] for o in ranks], launches_per_rank=[o["counts"] for o in ranks],
            held_against_plain=[o["held"] for o in ranks],
            ntt=[o.get("ntt") for o in ranks], step=[o.get("step") for o in ranks],
            shape_22=ranks[0].get("shape_22"))
        print(f"[sharded {label}] {world} rank(s) in {wall:.1f} s wall (spawn included)  ({card})")
    for k in K1_FORMS + ("K2", "K3", "K4"):
        assert counts[k] > 0, f"{k} not launched on the sharded path: {counts}"
    print(f"[sharded] launches on the path, all ranks: {json.dumps(counts)}  ({card})")
    rows = scaling_run(SCALING_PER_RANK, world_sizes=(1, 2), backend="gloo", device=None)
    assert all(r["correct"] for r in rows), rows
    for r in rows:
        print(f"[sharded] weak scaling: {r['devices']} gloo rank(s) on {r['device']}, {r['points']} points, "
              f"{r['seconds']:.4f} s  ({card})")
    if "main" in paths:
        line["main_prove_s"] = paths["main"]["prove_s"]
    line.update(launches=counts, scaling=rows)
    print(json.dumps({"sharded": line}))
    return dict(counts=counts)


def run_bench(card: str) -> dict:
    """The bench phase: ``python -m go_snark_study_tpu_torch.bench`` as a
    user runs it, in a process of its own, at BENCH_ENV's sizes.  It must
    exit 0 and print, last, bench.py's line: the headline
    msm_g1_points_per_sec_2^16, ``correct`` not false, no error_* key, the
    three shares at most 1, this card's name and power limit, and K1's
    forms, K2 and K3 launched in its run (the counts it resets at its start
    and reads at its end, in ``sub.launches``).  Prints the line as
    {"bench": ...}."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **BENCH_ENV)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "go_snark_study_tpu_torch.bench"], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for ln in proc.stderr.splitlines():
        print(f"[bench]   {ln}")
    assert proc.returncode == 0, f"[bench] exit {proc.returncode}: {proc.stdout[-2000:]}"
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    sub = line["sub"]
    head = f"msm_g1_points_per_sec_2^{int(BENCH_ENV['GOSNARK_BENCH_MSM']).bit_length() - 1}"
    assert line["metric"] == head, f"[bench] headline {line['metric']}, expected {head}"
    assert line.get("correct") is not False, "[bench] a result is wrong"
    errors = [k for k in sub if k.startswith("error_")]
    assert not errors, f"[bench] failed stages: {errors}"
    shares = sub.get("mfu", {})
    assert set(shares) == {"msm_accumulate", "ntt_butterfly", "modmul"} and all(0 < v <= 1 for v in shares.values()), \
        f"[bench] shares {shares}"
    assert sub.get("card") == card, f"[bench] card {sub.get('card')!r}, this card is {card!r}"
    counts = sub["launches"]
    for k in K1_FORMS + ("K2", "K3"):
        assert counts[k] > 0, f"{k} not launched on the bench path"
    print(f"[bench] python -m go_snark_study_tpu_torch.bench with {json.dumps(BENCH_ENV)}: exit 0, {wall:.1f} s "
          f"wall; {line['metric']} {line['value']:.0f} {line['unit']}, vs_baseline {line['vs_baseline']:.1f}  ({card})")
    print(json.dumps({"bench": line}))
    return dict(counts=counts, wall_s=wall)


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
    from go_snark_study_tpu_torch.profiling import kernel_objects
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    t_script, phase_s = time.perf_counter(), {}
    card = card_line()
    clock_hz = max_sm_clock_hz()
    print(f"[card] {card}; max SM clock {clock_hz / 1e6:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}")

    if "build" in phases:
        t_phase = time.perf_counter()
        log = _build.build_all()
        print(f"[build] {len(log)} kernel sources in {time.perf_counter() - t_phase:.1f} s wall  ({card})")
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
        phase_s["build"] = time.perf_counter() - t_phase

    # before any prove: the first row evaluation would make the library
    route = native_route(card)
    rows = {}
    if "kernels" in phases:
        t_phase = time.perf_counter()
        check_kernels(torch, clock_hz, rows, card)
        phase_s["kernels"] = time.perf_counter() - t_phase

    paths = {}
    if "main" in phases:
        t_phase = time.perf_counter()
        paths["main"] = run_path(torch, f"2^{MAIN_LOG}", mul_chain_r1cs(1 << MAIN_LOG, seed=1), 7, True, card)
        main_path = paths["main"]
        for k in K1_FORMS + ("K2", "K3", "SpMV"):
            assert main_path["counts"][k] > 0, f"{k} not launched on the 2^{MAIN_LOG} path"
        assert main_path["prove_counts"]["SpMV"] == 1, f"SpMV launched {main_path['prove_counts']['SpMV']} times"
        k1_per_prove = sum(main_path["prove_counts"][k] for k in K1_FORMS)
        assert k1_per_prove <= 80, f"K1 launched {k1_per_prove} times in one 2^{MAIN_LOG} prove"
        phase_s["main"] = time.perf_counter() - t_phase
    if "small" in phases:
        t_phase = time.perf_counter()
        small = paths["small"] = run_path(torch, f"2^{SMALL_LOG}", mul_chain_r1cs(1 << SMALL_LOG, seed=1), 7, True,
                                          card)
        assert small["prove_counts"]["K4"] == K4_PER_PROVE, \
            f"K4 whole-transform launched {small['prove_counts']['K4']} times in one 2^{SMALL_LOG} prove"
        assert small["counts"]["K4 stage"] == 0, f"K4 stage form launched on the 2^{SMALL_LOG} path"
        rows["small_vs_stage_path"] = compare_stage_path(torch, small, card)
        phase_s["small"] = time.perf_counter() - t_phase
    if "dsl" in phases:
        t_phase = time.perf_counter()
        paths["dsl"] = run_dsl(torch, card, paths.get("main"), route)
        phase_s["dsl"] = time.perf_counter() - t_phase
    if "parity" in phases:
        t_phase = time.perf_counter()
        paths["parity"] = run_parity(card)
        phase_s["parity"] = time.perf_counter() - t_phase
    if "cli" in phases:
        t_phase = time.perf_counter()
        paths["cli"] = run_cli(torch, card, paths)
        phase_s["cli"] = time.perf_counter() - t_phase
    if "sharded" in phases:
        t_phase = time.perf_counter()
        paths["sharded"] = run_sharded(torch, card, paths)
        phase_s["sharded"] = time.perf_counter() - t_phase
    if "ladder" in phases:
        t_phase = time.perf_counter()
        paths["ladder"] = run_ladder(torch, clock_hz, card)
        rows["ladder_sites"] = paths["ladder"]["sites"]
        phase_s["ladder"] = time.perf_counter() - t_phase
    if "chunked" in phases:
        t_phase = time.perf_counter()
        paths["chunked"] = run_chunked(torch, clock_hz, card)
        rows["chunked_sites"] = paths["chunked"]["sites"]
        phase_s["chunked"] = time.perf_counter() - t_phase
    if "bench" in phases:
        t_phase = time.perf_counter()
        paths["bench"] = run_bench(card)
        phase_s["bench"] = time.perf_counter() - t_phase

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
            "launches_by_path": {p: v["counts"][name] for p, v in paths.items()},
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
    # the chunked phase's call sites of K1, rows of their own: the apply and
    # merge-scan forms at the big chunk's shapes, the per-lane jadd_f as the
    # cross-chunk add (G1; the G2 rows are in the chunked_sites line)
    chunk_rows = {"chunk apply": "K1 apply", "chunk seg-scan": "K1 seg-scan", "cross-chunk jadd_f": "K1"}
    for row in rows.get("chunked_sites", []):
        if row["group"] != "G1" or row["site"] not in chunk_rows:
            continue
        obj = objs[chunk_rows[row["site"]]]
        kernels.append({
            "name": f"{obj.name} ({row['site']})",
            "route": "cuda",
            "source": obj.source_path,
            "replaces": obj.replaces,
            "launches": paths["chunked"]["counts"][chunk_rows[row["site"]]],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "wrapper_ms": row["wrapper_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "match": row["max_abs_err"] == 0,
            "shape": row["shape"],
            "path": "chunked 2^20 proof",
        })
    for key in ("K1_instances", "K1_sites", "K3_sites", "K4_sites", "K4_by_n", "small_vs_stage_path", "ladder_sites",
                "chunked_sites"):
        if key in rows:
            print(json.dumps({key.lower(): rows[key]}))
    print(f"[script] seconds by phase {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}; the whole script "
          f"{time.perf_counter() - t_script:.1f} s  ({card})")
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
