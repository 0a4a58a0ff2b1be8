"""Groth16 fast path: evaluation-form QAP over a roots-of-unity domain,
device-resident.

Mirrors ``go_snark_study_tpu/models/groth16_fast.py`` (``FastGroth16``,
``DevicePk``) on PyTorch, with the four hand-written CUDA kernels under it:

  * constraints live at the 2^k-th roots of unity, Z(x) = x^n - 1;
  * setup evaluates the QAP polynomials at tau via barycentric Lagrange
    values, commits with the fixed-base engine (K1 adds), and keeps the
    proving key ON DEVICE, affine-normalised (one tree batch inversion on
    K2), so every proof MSM runs mixed adds;
  * prove hands the witness to the device as bytes, written on the host
    into a pinned staging buffer that the prover keeps and copied without
    blocking, and computes the three row evaluations there, with the
    system's rows kept on the device since its first proof (the SpMV,
    :mod:`..ops.r1cs_spmv`; ``_cross_inputs``), builds
    one signed-digit sort plan shared by the three same-witness MSMs (G2
    included), runs four G1 MSMs and one G2 MSM (K1), each with its
    degeneracy flag and complete-formula re-run, builds H(x) with the
    coset-trick NTT pipeline (K3 from 2^14 up, K4 below, K2 for every
    product), and combines the window sums on the host;
  * proofs verify under :func:`.groth16.verify_proof`.

``warmup`` builds the kernels and the per-domain tables ahead of the first
prove, and with chunked engines runs one chunk of each family.  The
engines are unchunked by default (:mod:`..ops.msm`); assigning chunked
``msm_g1``/``msm_g2`` (``chunk_lanes=1 << 17``, ``small_chunk_lanes=1 << 14``
in G1 and ``0`` in G2) gives the JAX package's accelerator configuration,
and a key set up afterwards is padded to a multiple of its chunk.
``prove_sharded`` proves over a mesh of ranks (:mod:`..parallel`).  The JAX
prover's three-thread pool existed for concurrent XLA compiles; the port
enqueues the G1, G2 and H sides in that order on one stream.  With
``GOSNARK_MSM_PROFILE`` on (``1`` fenced, ``events`` unfenced:
:mod:`..profiling`), each proof is a ``prove`` span whose children time the
prover's phases (``prove.*``: ``prove.h`` is the H pipeline
``prove.h.ntt`` and the H MSM ``prove.h.msm``; each complete-formula
re-run is a ``prove.rerun`` under ``prove.flags``), and so are the setup's
host loops and its device commits (``setup.*``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from .. import _build
from ..bn128 import constants as C
from ..ops.curve_ops import G1Batch, G2Batch, tree_map
from ..ops.fixed_base import FixedBaseEngine
from ..ops.limbs import FieldKernels, bytes_to_rows, resolve_device, rows_to_limbs
from ..ops.msm import MSMEngine, combine_window_sums, scalars_to_windows
from ..ops.ntt import NTTEngine
from ..ops.r1cs_spmv import r1cs_spmv, row_csr
from ..profiling import span
from ..synthetic import SparseR1CS
from .context import ProtocolContext, default_context
from .groth16 import Pk, Proof, Setup, Toxic, assemble_proof

__all__ = ["FastGroth16", "DevicePk"]

_COSET_G = 5  # multiplicative generator of Fr*, not in any 2^k subgroup


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def _group_budget(device) -> dict:
    """The engines' window-group budget (``MSMEngine(group_bytes=)``): on a
    card its memory, elsewhere the JAX engine's default.  That default, 3
    GiB counted in the JAX layout's 384 bytes a G1 lane and window, was
    sized for a TPU; on the card it cut a 2^21 MSM's 20 windows into
    launches of 4 (G1) and 2 (G2) windows of 2,048 lanes and 1,024 serial
    steps, too few lanes to fill the card.  The port's plan takes a fraction
    of what the budget counts: a 2^21 G1 MSM in one group peaks below 4 GB.
    Grouping leaves each window's additions in their order, so the window
    sums are the same integers."""
    if device.type != "cuda":
        return {}
    return {"group_bytes": torch.cuda.get_device_properties(device).total_memory}


@dataclass
class DevicePk:
    """Device-resident proving key: affine point pytrees, lane-padded.

    Identity padding lanes are (0, 0, 0) — absorbed by the branchless group
    law, so padded MSMs are exact."""

    n: int  # evaluation domain size (power of two)
    m: int  # signal count
    lo: int  # first private index (n_public + 1)
    m_pad: int
    mp_pad: int  # padded private count
    n_pad: int
    at: object = None  # G1 affine, m_pad lanes
    b1: object = None  # G1 affine, m_pad lanes
    b2: object = None  # G2 affine, m_pad lanes
    cdelta: object = None  # G1 affine, mp_pad lanes (private signals only)
    ptau: object = None  # G1 affine, n_pad lanes (tau^i Z(tau)/delta)


@dataclass
class _Staging:
    """One witness length's host buffer and the event recorded after the
    last copy out of it."""

    buf: torch.Tensor
    copied: Optional[object] = None  # torch.cuda.Event


class FastGroth16:
    """Holds the engines for one device; reusable across circuits and proof
    calls.  ``device=None`` is the card (and raises without one); the CPU
    runs the kernels' plain versions and only when asked for."""

    def __init__(self, ctx: Optional[ProtocolContext] = None, device=None):
        self.ctx = ctx or default_context()
        self.device = resolve_device(device)
        self.Kq = FieldKernels(C.Q, self.device)
        self.Kr = FieldKernels(C.R, self.device)
        self.g1b, self.g2b = G1Batch(self.Kq), G2Batch(self.Kq)
        self.ntt = NTTEngine(self.Kr)
        bn = self.ctx.bn
        budget = _group_budget(self.device)
        self.msm_g1 = MSMEngine(self.g1b, bn.g1, C.R, **budget)
        # no small chunk family for G2, as in the JAX package: the small
        # tiers' G2 MSM pads into the big chunks (inert while unchunked)
        self.msm_g2 = MSMEngine(self.g2b, bn.g2, C.R, small_chunk_lanes=0, **budget)
        self._fb_g1: Optional[FixedBaseEngine] = None
        self._fb_g2: Optional[FixedBaseEngine] = None
        self._sharded_provers: dict = {}
        self._h_progs: dict = {}
        self._stagings: dict = {}
        # degeneracy re-runs inside proofs, by MSM: at, b1 and cd (C's
        # private part) in G1, h (the H MSM) in G1, b2 in G2
        self.rerun_counts = dict.fromkeys(("at", "b1", "cd", "h", "b2"), 0)

    # -- fixed-base engines (their host tables are built on first use) --
    @property
    def fb_g1(self) -> FixedBaseEngine:
        if self._fb_g1 is None:
            bn = self.ctx.bn
            self._fb_g1 = FixedBaseEngine(self.g1b, bn.g1, bn.g1.g, C.R)
        return self._fb_g1

    @property
    def fb_g2(self) -> FixedBaseEngine:
        if self._fb_g2 is None:
            bn = self.ctx.bn
            self._fb_g2 = FixedBaseEngine(self.g2b, bn.g2, bn.g2.g, C.R)
        return self._fb_g2

    # ------------------------------------------------------------------
    def warmup(
        self,
        families=("big",),
        domains=(),
        g2: bool = True,
        fixed_base: bool = False,
    ) -> dict:
        """Do ahead of time what the first setup or prove would otherwise
        pay for, with the JAX package's signature.  On the card it builds
        every kernel (``_build.build_all``; the CPU runs the plain versions
        and builds nothing).  ``families``: with chunked engines, "big" and
        "small" each run one chunk of that family (digits and plan, then
        apply, the cross-chunk ``badd`` and the reduction, each a step) on
        identity points with zero scalars, in G1 and, with ``g2``, in G2
        where G2 routes that chunk width to itself; with unchunked engines
        any non-empty value runs the tiled pieces (plan, apply, merge scan,
        reduction) once at the tiled path's smallest lane count, in G1
        and, with ``g2``, in G2.  ``domains``: for each evaluation-domain size,
        build the NTT tables and run the H pipeline once on zeros.
        ``fixed_base``: build the fixed-base tables and run one
        ``batch_mul([1])`` per group, plus one ``to_affine``.  Idempotent:
        a second call finds everything cached.  Returns each step's
        seconds (the JAX package only logs them); there is no thread pool,
        as there are no compiles to overlap."""
        dev = self.device
        steps = {}

        def step(label, fn):
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            steps[label] = time.perf_counter() - t0
            return out

        if dev.type == "cuda":
            step("build", _build.build_all)
        eng = self.msm_g1
        fams = [ch for name, ch in (("big", eng.chunk_lanes), ("small", eng.small_chunk_lanes))
                if name in families and ch]
        for lanes in fams:
            c = eng.window_bits_for(lanes)
            limbs = torch.zeros((8, lanes), dtype=torch.int32, device=dev)
            plans = step(f"msm[c{c},{lanes}].plan", lambda: eng._plans(limbs, c, lanes, lanes))
            groups = ((self.msm_g1, self.g1b),)
            if g2 and self.msm_g2._chunk_for(lanes) == lanes:  # G2 runs only the families it routes to
                groups += ((self.msm_g2, self.g2b),)
            for msm, bg in groups:
                tag = f"msm[arity{bg._arity},c{c},{lanes}]"
                aff = bg.zeros(lanes)
                b, _ = step(f"{tag}.apply", lambda: msm._apply_impl(aff, plans["chunks"][0][0], c))
                b2, _ = step(f"{tag}.badd", lambda: msm._badd(b, b))
                step(f"{tag}.reduce", lambda: msm._reduce_buckets(b2, c))
        if families and not fams:
            lanes = eng.tile_threshold
            c = eng.window_bits_for(lanes)
            limbs = torch.zeros((8, lanes), dtype=torch.int32, device=dev)
            plans = eng.make_plans(limbs, c)
            groups = ((eng, self.g1b, "msm_g1"),) + (((self.msm_g2, self.g2b, "msm_g2"),) if g2 else ())
            for msm, bg, label in groups:
                step(label, lambda: msm.window_sums_eager(bg.zeros(lanes), limbs, c, plans))
        for nd in domains:
            nd = int(nd)
            zeros = torch.zeros((8, nd), dtype=torch.int32, device=dev)
            step(f"h[2^{nd.bit_length() - 1}]",
                 lambda: self._get_h_jit(nd, self._pad_for(nd))(zeros, zeros, zeros, *self._ntt_args(nd)))
        if fixed_base:
            step("fb_g1", lambda: self.fb_g1.batch_mul([1]))
            if g2:
                step("fb_g2", lambda: self.fb_g2.batch_mul([1]))
            step("affine_g1", lambda: self.g1b.to_affine(self.g1b.zeros(8192)))
        return steps

    # ------------------------------------------------------------------
    def _lagrange_at_tau(self, n: int, tau: int):
        """L_j(tau) = w^j (tau^n - 1) / (n (tau - w^j)) for j = 0..n-1,
        via one batched inversion (Montgomery's trick)."""
        r = C.R
        w = self.ntt.root_of_unity(n)
        pw = [1] * n
        for j in range(1, n):
            pw[j] = pw[j - 1] * w % r
        denoms = [(tau - pw[j]) % r for j in range(n)]
        prefix = [1] * (n + 1)
        for j in range(n):
            prefix[j + 1] = prefix[j] * denoms[j] % r
        inv_all = pow(prefix[n], -1, r)
        invs = [0] * n
        for j in range(n - 1, -1, -1):
            invs[j] = inv_all * prefix[j] % r
            inv_all = inv_all * denoms[j] % r
        zt = (pow(tau, n, r) - 1) % r
        ninv = pow(n, -1, r)
        scale = zt * ninv % r
        return [pw[j] * scale % r * invs[j] % r for j in range(n)]

    # ------------------------------------------------------------------
    def _pad_for(self, n: int) -> int:
        return n + ((-n) % self.msm_g1.pad_quantum(n))

    def _device_pk_from_scalars(
        self, n: int, m: int, lo: int, ats, bts, cdelta_priv, ladder
    ) -> DevicePk:
        """Commit scalar vectors with the fixed-base engines, keeping every
        result on device, then affine-normalise once."""
        m_pad = self._pad_for(m)
        mp_pad = self._pad_for(m - lo)
        n_pad = self._pad_for(n)

        def commit(fb, bg, scalars, lanes):
            scs = list(scalars) + [0] * (lanes - len(scalars))
            jac = fb.batch_mul_device(scalars_to_windows(scs, C.R, self.device))
            return bg.to_affine(jac)

        return DevicePk(
            n=n,
            m=m,
            lo=lo,
            m_pad=m_pad,
            mp_pad=mp_pad,
            n_pad=n_pad,
            at=commit(self.fb_g1, self.g1b, ats, m_pad),
            b1=commit(self.fb_g1, self.g1b, bts, m_pad),
            b2=commit(self.fb_g2, self.g2b, bts, m_pad),
            cdelta=commit(self.fb_g1, self.g1b, cdelta_priv, mp_pad),
            ptau=commit(self.fb_g1, self.g1b, ladder[:n], n_pad),
        )

    # ------------------------------------------------------------------
    def setup(self, r1cs: SparseR1CS, rng=None, materialize_host: bool = True) -> Setup:
        """Evaluation-form trusted setup; same artifact shapes as the JAX
        package's (groth16.go:94-222).  The proving key stays
        device-resident (``pk._device``); host lists are materialised only
        when ``materialize_host`` (needed for JSON serialization; the
        binary key file and the prover need none)."""
        ctx = self.ctx
        r = C.R
        n = _next_pow2(r1cs.n_constraints)
        m = r1cs.n_signals

        tox = Toxic(
            t=ctx.rand_fr(rng),
            kalpha=ctx.rand_fr(rng),
            kbeta=ctx.rand_fr(rng),
            kgamma=ctx.rand_fr(rng),
            kdelta=ctx.rand_fr(rng),
        )
        setup = Setup(toxic=tox)
        pk, vk = setup.pk, setup.vk

        with span("setup.lagrange"):
            L = self._lagrange_at_tau(n, tox.t)

        def col_evals(rows):
            out = [0] * m
            for j, row in enumerate(rows):
                lj = L[j]
                for i, coeff in row.items():
                    out[i] = (out[i] + coeff * lj) % r
            return out

        with span("setup.col_evals"):
            ats = col_evals(r1cs.A)
            bts = col_evals(r1cs.B)
            cts = col_evals(r1cs.C)

        # Z(x) = x^n - 1
        pk.z = [r - 1] + [0] * (n - 1) + [1]
        zt = (pow(tox.t, n, r) - 1) % r
        inv_delta = pow(tox.kdelta, -1, r)
        inv_gamma = pow(tox.kgamma, -1, r)

        # powers-of-tau ladder (pre-scaled by Z(t)/delta like the reference,
        # groth16.go:139-149), length n+1 = len(z); H has degree <= n-2 so
        # the device key keeps the first n entries
        ztd = zt * inv_delta % r
        with span("setup.ladder"):
            ladder = [ztd]
            acc = tox.t
            for _ in range(1, len(pk.z)):
                ladder.append(acc * ztd % r)
                acc = acc * tox.t % r

        lo = r1cs.n_public + 1
        with span("setup.bac"):
            bac = [
                (ats[i] * tox.kbeta + bts[i] * tox.kalpha + cts[i]) % r
                for i in range(m)
            ]
            cdelta_priv = [x * inv_delta % r for x in bac[lo:]]

        with span("setup.commit", self.device):
            pk._device = self._device_pk_from_scalars(n, m, lo, ats, bts, cdelta_priv, ladder)

        g1, g2 = ctx.bn.g1, ctx.bn.g2
        pk.g1.alpha = g1.mul_scalar(g1.g, tox.kalpha)
        pk.g1.beta = g1.mul_scalar(g1.g, tox.kbeta)
        pk.g1.delta = g1.mul_scalar(g1.g, tox.kdelta)
        pk.g2.beta = g2.mul_scalar(g2.g, tox.kbeta)
        pk.g2.gamma = g2.mul_scalar(g2.g, tox.kgamma)
        pk.g2.delta = g2.mul_scalar(g2.g, tox.kdelta)
        vk.g1.alpha = pk.g1.alpha
        vk.g2.beta = pk.g2.beta
        vk.g2.gamma = pk.g2.gamma
        vk.g2.delta = pk.g2.delta
        vk.ic = self.fb_g1.batch_mul([x * inv_gamma % r for x in bac[:lo]])

        if materialize_host:
            dpk = pk._device
            first = lambda pt, k: tree_map(lambda x: x[..., :k].contiguous(), pt)
            pk.g1.at = self.g1b.unpack(first(dpk.at, m))
            pk.g1.bacgamma = self.g1b.unpack(first(dpk.b1, m))
            pk.g2.bacgamma = self.g2b.unpack(first(dpk.b2, m))
            pk.bacdelta = [g1.zero()] * lo + self.g1b.unpack(first(dpk.cdelta, m - lo))
            pk.powers_tau_delta = self.g1b.unpack(first(dpk.ptau, n)) + self.fb_g1.batch_mul(ladder[n:])
        return setup

    # ------------------------------------------------------------------
    def _device_pk(self, pk: Pk, n: int, lo: int) -> DevicePk:
        """Device key from a host Pk (packs + affine-normalises once, cached
        on the Pk object)."""
        if getattr(pk, "_device", None) is not None:
            return pk._device
        m = len(pk.g1.at)
        m_pad = self._pad_for(m)
        mp_pad = self._pad_for(m - lo)
        n_pad = self._pad_for(n)
        zero1, zero2 = self.ctx.bn.g1.zero(), self.ctx.bn.g2.zero()

        def packa(bg, pts, lanes, zero):
            arr = list(pts) + [zero] * (lanes - len(pts))
            return bg.to_affine(bg.pack(arr))

        pk._device = DevicePk(
            n=n,
            m=m,
            lo=lo,
            m_pad=m_pad,
            mp_pad=mp_pad,
            n_pad=n_pad,
            at=packa(self.g1b, pk.g1.at, m_pad, zero1),
            b1=packa(self.g1b, pk.g1.bacgamma, m_pad, zero1),
            b2=packa(self.g2b, pk.g2.bacgamma, m_pad, zero2),
            cdelta=packa(self.g1b, pk.bacdelta[lo:], mp_pad, zero1),
            ptau=packa(self.g1b, pk.powers_tau_delta[:n], n_pad, zero1),
        )
        return pk._device

    def _ntt_args(self, n: int):
        """The device-resident NTT tables for domain n."""
        ntt = self.ntt
        return (
            ntt.table(n, False),
            ntt.table(n, True),
            ntt.coset_powers(n, _COSET_G, False),
            ntt.coset_powers(n, _COSET_G, True),
        )

    def _h_pipeline(self, n: int):
        """H(x) pipeline: evaluation-form a, b, c (8, n) Montgomery + the
        four NTT tables -> H coefficients (8, n) Montgomery, via the coset
        trick (Z = g^n - 1 is a nonzero constant off the subgroup)."""
        r = C.R
        K, ntt = self.Kr, self.ntt
        g = _COSET_G
        zinv_l = K.pack([pow((pow(g, n, r) - 1) % r, -1, r)])
        ninv_l = K.pack([pow(n, -1, r)])

        def pipeline(a, b, c, t_fwd, t_inv, cs, cs_inv):
            intt = lambda x: K.mul_const(ntt.transform(x, t_inv, True), ninv_l)
            to_coset = lambda x: ntt.transform(ntt.coset_shift(intt(x), powers=cs), t_fwd, False)
            ac, bc, cc = to_coset(a), to_coset(b), to_coset(c)
            p = K.sub(K.mul(ac, bc), cc)
            hc = K.mul_const(p, zinv_l)
            return ntt.coset_shift(intt(hc), powers=cs_inv)

        return pipeline

    def _get_h_jit(self, n: int, n_pad: int):
        """H(x) program: evaluation-form a, b, c -> canonical H-coefficient
        limbs (the MSM digit source), padded to the ptau lane count.  The
        name follows the JAX package; PyTorch runs it eagerly.  One program
        per (n, n_pad), kept: its two constants are packed once."""
        key = (n, n_pad)
        if key in self._h_progs:
            return self._h_progs[key]
        h_pipe = self._h_pipeline(n)
        Kr = self.Kr
        pad = n_pad - n

        def h_digits(a_e, b_e, c_e, *ntt_args):
            h_plain = Kr.from_mont(h_pipe(a_e, b_e, c_e, *ntt_args))
            if pad:
                h_plain = torch.nn.functional.pad(h_plain, (0, pad))
            return h_plain

        self._h_progs[key] = h_digits
        return h_digits

    def _staging(self, m: int):
        """The host buffer of an m-signal witness, uint8, 32 bytes a value,
        pinned on a CUDA device.  One a length, kept; before handing it out
        again this waits for the copy of the proof that last filled it (a
        CUDA event), so that no proof in flight has its input overwritten."""
        st = self._stagings.get(m)
        if st is None:
            st = self._stagings[m] = _Staging(torch.empty(32 * m, dtype=torch.uint8,
                                                          pin_memory=self.device.type == "cuda"))
        elif st.copied is not None:
            st.copied.synchronize()
        return st

    def _cross_inputs(self, r1cs: SparseR1CS, n: int, *cuts):
        """The prover's host-to-device crossing, over a domain of n rows.
        The witness is encoded straight into its staging buffer
        (:meth:`_staging`; ``SparseR1CS._witness_into``), crosses once by a
        non-blocking copy and is laid out there: for each cut ``(first,
        lanes)``, the witness values from ``first`` on as (8, lanes) plain
        limbs, zero padded, an MSM digit source.  The three products are one
        SpMV over the system's rows (:func:`..ops.r1cs_spmv.r1cs_spmv`: the
        kernel on the card, its plain version on the CPU), on the witness as
        it crossed; the rows go to the device at the system's first proof
        and stay there (:func:`..ops.r1cs_spmv.row_csr`).  Returns (the
        cuts' limbs, (a, b, c) (8, n) in Montgomery form: the H pipeline's
        inputs).  Both provers cross their inputs here."""
        dv = self.device
        csr = row_csr(r1cs, n, dv)
        with span("prove.row_evals"):
            st = self._staging(len(r1cs.witness))
            r1cs._witness_into(st.buf.numpy())
        with span("prove.witness", dv):
            w_rows = bytes_to_rows(st.buf, dv)
            if dv.type == "cuda":
                st.copied = torch.cuda.Event()
                st.copied.record()
            limbs = [rows_to_limbs(w_rows[first : first + lanes], lanes) for first, lanes in cuts]
        with span("prove.h_inputs", dv):
            with span("prove.h_inputs.products", dv):
                h_in = tuple(r1cs_spmv(csr, w_rows))
        return limbs, h_in

    def _prove_inputs(self, r1cs: SparseR1CS, dpk: DevicePk):
        """The single-card prover's crossing (:meth:`_cross_inputs`):
        (w_limbs (8, m_pad) and wp_limbs (8, mp_pad), the witness and its
        private part as plain limbs; (a, b, c) (8, n), the H pipeline's
        inputs)."""
        (w_limbs, wp_limbs), h_in = self._cross_inputs(r1cs, dpk.n, (0, dpk.m_pad), (dpk.lo, dpk.mp_pad))
        return w_limbs, wp_limbs, h_in

    def _checked(self, key: str, eng: MSMEngine, sums, bad, redo):
        """``eng.rerun_if_flagged`` for the proof's MSM ``key`` (at, b1 and
        cd, C's private part, in G1, h, the H MSM, in G1, b2 in G2): a
        re-run is counted in ``rerun_counts`` and spanned ``prove.rerun``."""

        def rerun(twin):
            self.rerun_counts[key] += 1
            with span("prove.rerun", self.device):
                return redo(twin)

        return eng.rerun_if_flagged(sums, bad, rerun)

    # ------------------------------------------------------------------
    def prove_sharded(self, r1cs: SparseR1CS, pk: Pk, mesh, rng=None) -> Proof:
        """Prove over ``mesh`` (:mod:`..parallel.mesh`): called on every
        rank with the same host-materialised ``pk`` and an ``rng`` in the
        same state, it returns the same proof there.  Each rank keeps its
        slice of the key on its device (cached on the Pk) and runs the five
        MSMs over it; the window sums are combined on the host.  The input
        crossing, the complete-formula re-runs and the proof assembly are
        :meth:`prove`'s.  One prover per mesh, cached."""
        from ..parallel.sharded_prover import ShardedFastProver

        key = id(mesh)
        if key not in self._sharded_provers:
            self._sharded_provers[key] = ShardedFastProver(self, mesh)
        return self._sharded_provers[key].prove(r1cs, pk, rng=rng)

    # ------------------------------------------------------------------
    def prove(self, r1cs: SparseR1CS, pk: Pk, rng=None) -> Proof:
        """Groth16 prover: same assembly as groth16.generate_proofs
        (groth16.go:225-279) with the NTT H(x) and device MSMs; the
        ``prove`` span, the root of a proof's phases."""
        with span("prove", self.device):
            return self._prove(r1cs, pk, rng)

    def _prove(self, r1cs: SparseR1CS, pk: Pk, rng) -> Proof:
        ctx = self.ctx
        g1, g2 = ctx.bn.g1, ctx.bn.g2
        n = _next_pow2(r1cs.n_constraints)
        lo = r1cs.n_public + 1
        dpk = self._device_pk(pk, n, lo)

        r_rand = ctx.rand_fr(rng)
        s_rand = ctx.rand_fr(rng)

        dv = self.device
        # host -> device, before any device work is enqueued: witness limbs
        # and the evaluation-form row combinations
        w_limbs, wp_limbs, (a_d, b_d, c_d) = self._prove_inputs(r1cs, dpk)

        c_m = self.msm_g1.window_bits_for(dpk.m_pad)
        c_p = self.msm_g1.window_bits_for(dpk.mp_pad)
        c_h = self.msm_g1.window_bits_for(dpk.n_pad)
        # G2 has no small chunk family: where its window width differs from
        # G1's, it builds its own plan
        c_m2 = self.msm_g2.window_bits_for(dpk.m_pad)
        # ONE sort/compaction plan for the witness scalars, shared by the
        # three same-scalar MSMs (at, b1 in G1 AND b2 in G2 — plans carry no
        # group data)
        with span("prove.plans", dv):
            plans_w = self.msm_g1.make_plans(w_limbs, c_m)
        plans_w2 = plans_w if c_m2 == c_m else None

        # G1 side, G2 side, H side, enqueued in order on one stream; the
        # flags stay on the device until all five MSMs are in flight
        with span("prove.msm", dv):
            s_at = self.msm_g1.window_sums_eager(dpk.at, w_limbs, c_m, plans_w)
            s_b1 = self.msm_g1.window_sums_eager(dpk.b1, w_limbs, c_m, plans_w)
            s_cd = self.msm_g1.window_sums_eager(dpk.cdelta, wp_limbs, c_p)
            s_b2 = self.msm_g2.window_sums_eager(dpk.b2, w_limbs, c_m2, plans_w2)
        with span("prove.h", dv):
            with span("prove.h.ntt", dv):
                h_digits = self._get_h_jit(n, dpk.n_pad)(a_d, b_d, c_d, *self._ntt_args(n))
            with span("prove.h.msm", dv):
                s_h = self.msm_g1.window_sums_eager(dpk.ptau, h_digits, c_h)

        # degeneracy-flag check: an incomplete-formula MSM whose flag fired
        # runs again on the complete-engine twin (exact always)
        def chk(key, eng, sf, pts, limbs, c, plans=None):
            return self._checked(key, eng, *sf, lambda twin: twin.window_sums_eager(pts, limbs, c, plans)[0])

        with span("prove.flags", dv):
            s_at = chk("at", self.msm_g1, s_at, dpk.at, w_limbs, c_m, plans_w)
            s_b1 = chk("b1", self.msm_g1, s_b1, dpk.b1, w_limbs, c_m, plans_w)
            s_cd = chk("cd", self.msm_g1, s_cd, dpk.cdelta, wp_limbs, c_p)
            s_h = chk("h", self.msm_g1, s_h, dpk.ptau, h_digits, c_h)
            sums_b2 = chk("b2", self.msm_g2, s_b2, dpk.b2, w_limbs, c_m2, plans_w2)

        with span("prove.combine"):
            comb1 = lambda sums, c: combine_window_sums(g1, self.g1b.unpack(sums), c)
            pi_a = comb1(s_at, c_m)
            pi_b_g1 = comb1(s_b1, c_m)
            pi_b = combine_window_sums(g2, self.g2b.unpack(sums_b2), c_m2)
            pi_c = comb1(s_cd, c_p)
            pi_h = comb1(s_h, c_h)

        with span("prove.assemble"):
            return assemble_proof(ctx, pk, r_rand, s_rand, pi_a, pi_b_g1, pi_b, pi_c, pi_h)
