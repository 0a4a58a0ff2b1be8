"""Pippenger multi-scalar multiplication.

Mirrors ``go_snark_study_tpu/ops/msm.py`` (``MSMEngine``): signed window
digits, one device-resident sort/compaction plan per scalar vector (shared
by the prover's three same-witness MSMs, G2 included), tiled bucket
accumulation with incomplete adds and a degeneracy flag, a segmented
Hillis-Steele merge, and the parallel bucket reduction; the W window sums
are combined on the host in exact arithmetic.

Chunk families (``chunk_lanes``, ``small_chunk_lanes``,
``small_chunk_max``, with the JAX engine's meaning): an MSM of any size at
or above ``tile_threshold`` streams through fixed-width chunks, 2^17 lanes
at c = 13 (the big family) or 2^14 lanes at c = 11 for n <= 2^15 (the
small family; ``small_chunk_lanes=0`` means none).  Each chunk's window
groups are applied and merged, the chunks' buckets are summed by K1's
per-lane flagged add (``badd``, JAX operand order: buckets so far, then
this chunk's), and the reduction runs once at the end.

What differs from the JAX package:

  * The default is unchunked on every device, the card included.  The JAX
    engine turns the families on only on a TPU backend, to bound its XLA
    compiles (one per shape); the port compiles nothing per shape, so
    ``chunk_lanes=None`` keeps the unchunked path the JAX package takes on
    the CPU, with the same window width and tiling for a given point
    count.  Pass the chunk parameters to get the TPU configuration.
  * ``jnp.argsort`` is stable; ``torch.sort(..., stable=True)`` keeps the
    same order, so buckets accumulate in the same order and the window sums
    are the same Jacobian coordinates.
  * The serial loops (tiled accumulation with compaction, the merge
    scan's steps, the bucket reduction) are K1's MSM forms
    (:mod:`.msm_kernels`): one launch each, every lane's loop inside the
    kernel.  The flags stay on the device until the caller reads them once.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

from ..profiling import span
from . import msm_kernels as _mk
from .curve_ops import tree_leaves, tree_map
from ..native import combine_windows, ints_to_bytes
from .limbs import LIMBS, bytes_to_limbs, to_u64

__all__ = [
    "MSMEngine",
    "scalars_to_limbs",
    "digits_from_limbs",
    "signed_digits_from_limbs",
    "num_windows",
    "bucket_count",
    "choose_window_bits",
    "combine_window_sums",
    "scalars_to_windows",
    "WINDOW_BITS",
    "NUM_WINDOWS",
]

# 8-bit windows: the fixed-base table radix (ops/fixed_base)
WINDOW_BITS = 8
NUM_WINDOWS = 32

SCALAR_BITS = 254  # BN128 r bit length
_TILE_LANES = 2048

# the JAX engine's canonical chunk families: lanes and window width
_BIG_CHUNK = 1 << 17
_SMALL_CHUNK = 1 << 14
_BIG_C = 13
_SMALL_C = 11


def scalars_to_limbs(scalars: Sequence[int], modulus: int, device) -> torch.Tensor:
    """Scalars -> (8, N) int32 32-bit limbs (plain, not Montgomery): the
    field layout, so that a Montgomery exit (``from_mont``) on the device
    yields MSM digits directly.  Each s mod ``modulus`` crosses as 32 bytes
    and is relaid on the device (:func:`.limbs.bytes_to_limbs`)."""
    return bytes_to_limbs(ints_to_bytes(scalars, modulus), device)


def scalars_to_windows(scalars: Sequence[int], modulus: int, device) -> torch.Tensor:
    """Scalars -> (32, N) int32 radix-2^8 digits: the fixed-base table's
    window digits (``WINDOW_BITS``).  The JAX package's name; its 8-bit
    limbs are these digits."""
    return digits_from_limbs(scalars_to_limbs(scalars, modulus, device), WINDOW_BITS)


def num_windows(c: int) -> int:
    return -(-SCALAR_BITS // c)


def bucket_count(c: int) -> tuple:
    """(m_buckets, d_chunk) for signed windows of width c: magnitudes span
    0..2^(c-1), padded up so the reduction's power-of-two chunk width
    divides the bucket count (padding slots hold identities)."""
    m0 = (1 << (c - 1)) + 1
    dc = 64 if m0 > 1024 else 16 if m0 > 64 else 8 if m0 > 8 else 4
    return -(-m0 // dc) * dc, dc


def choose_window_bits(n: int) -> int:
    """The JAX package's window width table (its break-evens are flat)."""
    if n >= 1 << 19:
        return 13
    if n >= 1 << 17:
        return 12
    if n >= 1 << 15:
        return 11
    if n >= 1 << 13:
        return 10
    return 8


def digits_from_limbs(limbs: torch.Tensor, c: int) -> torch.Tensor:
    """(8, N) 32-bit limbs -> (W, N) int32 UNSIGNED radix-2^c digits.
    Window w covers scalar bits [w*c, (w+1)*c), at most two limbs."""
    u = to_u64(limbs)
    mask = (1 << c) - 1
    rows = []
    for w in range(num_windows(c)):
        lo_bit = w * c
        b0, sh = lo_bit // 32, lo_bit % 32
        d = u[b0] >> sh
        if sh + c > 32 and b0 + 1 < LIMBS:
            d = d | (u[b0 + 1] << (32 - sh))
        rows.append((d & mask).to(torch.int32))
    return torch.stack(rows)


def signed_digits_from_limbs(limbs: torch.Tensor, c: int) -> torch.Tensor:
    """(8, N) 32-bit limbs -> (W, N) int32 SIGNED radix-2^c digits in
    the balanced range [-(2^(c-1)-1), 2^(c-1)], via carry recoding."""
    assert num_windows(c) * c >= SCALAR_BITS + 1, (
        f"window width {c} leaves no carry headroom above {SCALAR_BITS} bits"
    )
    raw = digits_from_limbs(limbs, c)
    half = 1 << (c - 1)
    full = 1 << c
    rows = []
    carry = torch.zeros_like(raw[0])
    for w in range(raw.shape[0]):
        d = raw[w] + carry
        flip = d > half
        rows.append(torch.where(flip, d - full, d))
        carry = flip.to(torch.int32)
    return torch.stack(rows)


def combine_window_sums(host_group, window_pts, c: int):
    """Exact host combination: Σ_w 2^(c·w) · S_w, MSB window first (the
    ``msm.combine`` span).  The chain runs in C (``native.combine_windows``,
    the same triple); the loop here where the C takes no such inputs or the
    group has no field of ``fields``."""
    with span("msm.combine"):
        total = combine_windows(getattr(host_group, "F", None), window_pts, c)
        if total is None:
            total = host_group.zero()
            for wp in reversed(window_pts):
                for _ in range(c):
                    total = host_group.double(total)
                total = host_group.add(total, wp)
    return total


class MSMEngine:
    """MSM over one group (G1Batch or G2Batch) with its host group for the
    final exact combination step.

    ``tile_threshold``: point counts below this use the simple (sort + one
    log-scan) path; above it the tiled pipeline.  ``tile_steps``: explicit
    serial step count K of the tiled path; by default tiles are sized so
    that each window contributes ``tile_lanes`` lanes (tests lower either
    to reach that path at a small size).  ``group_bytes``: memory budget of
    one window group's partial sums, counted in the JAX layout's bytes so
    that both engines group windows alike; it bounds how many windows share
    a pass.  ``chunk_lanes`` / ``small_chunk_lanes`` / ``small_chunk_max``:
    the chunk families (module docstring); ``None`` (the default) is the
    unchunked path, ``small_chunk_lanes=0`` no small family, and
    ``small_chunk_max`` defaults to twice the small chunk.  ``complete``:
    use the complete group law instead of the incomplete+flag fast path —
    the fallback target.
    """

    def __init__(
        self,
        batch_group,
        host_group,
        scalar_modulus: int,
        window_bits: int | None = None,
        tile_threshold: int = 8192,
        tile_steps: int | None = None,
        tile_lanes: int = _TILE_LANES,
        group_bytes: int = 3 << 30,
        chunk_lanes: int | None = None,
        small_chunk_lanes: int | None = None,
        small_chunk_max: int | None = None,
        complete: bool = False,
    ):
        self.bg = batch_group
        self.host_group = host_group
        self.r = scalar_modulus
        self.window_bits = window_bits
        self.tile_threshold = tile_threshold
        self.tile_steps = tile_steps
        self.tile_lanes = tile_lanes
        self.group_bytes = group_bytes
        self.complete = complete
        self.chunk_lanes = chunk_lanes
        self.small_chunk_lanes = small_chunk_lanes or None
        self.small_chunk_max = small_chunk_max or (2 * small_chunk_lanes if small_chunk_lanes else 0)
        self._fallback = None
        self.fallback_hits = 0  # degeneracy-flag re-runs (observability)

    @property
    def device(self):
        return self.bg.K.device

    # ------------------------------------------------------------------
    # parameter selection
    # ------------------------------------------------------------------
    def _chunk_for(self, n: int) -> Optional[int]:
        """The chunk width n streams through (None: the unchunked path).
        A chunked MSM pads to a multiple of its chunk and takes the
        family's window width."""
        if self.chunk_lanes is None or n < self.tile_threshold:
            return None
        if self.small_chunk_lanes and n <= self.small_chunk_max:
            return self.small_chunk_lanes
        return self.chunk_lanes

    def _canonical(self, n: int) -> bool:
        return self._chunk_for(n) is not None

    def window_bits_for(self, n: int) -> int:
        if self.window_bits:
            return self.window_bits
        ch = self._chunk_for(n)
        if ch is not None:
            return _SMALL_C if ch == self.small_chunk_lanes else _BIG_C
        return choose_window_bits(n)

    def pad_quantum(self, n: int) -> int:
        ch = self._chunk_for(n)
        if ch is not None:
            return ch
        if n >= self.tile_threshold:
            return self.tile_steps or self.tile_lanes
        return 128

    def _coord_bytes(self) -> int:
        # bytes per point-lane in the JAX layout: 3 coords x arity x 32 x 4 B
        # (kept so that the window grouping matches the JAX engine's)
        return 3 * self.bg._arity * 32 * 4

    def _group_size(self, n: int, w: int) -> int:
        by_mem = max(1, self.group_bytes // (n * self._coord_bytes()))
        return max(1, min(w, by_mem))

    def _tile_split(self, n: int):
        """(K serial steps, m lanes per window) for an n-lane stream."""
        k = self.tile_steps or max(2, n // self.tile_lanes)
        return k, n // k

    def _p_cap(self, n: int, c: int) -> int:
        """Compaction width of a window's run partials: at most one run
        opening per bucket plus one per tile lane, padded to 128."""
        p_cap = min(n, bucket_count(c)[0] + self._tile_split(n)[1])
        return p_cap + (-p_cap) % 128

    def layout(self, n: int, c: int | None = None) -> dict:
        """What :meth:`make_plans` gives an n-lane scalar vector, from the
        engine's rules alone (no tensor): window width ``c``, windows ``w``;
        on the tiled and chunk paths the lanes a plan covers ``span`` (n,
        or the chunk), the ``chunks`` (n padded up to the span, over it),
        the windows per group ``wg``, the zero windows ``wpad`` that fill
        the last group, the ``groups`` per chunk, the serial steps ``k``
        and lanes per window ``m`` of the accumulation, the compaction
        width ``p_cap``, the merge scan's ``seg_steps`` and the cross-chunk
        bucket adds ``badds`` (chunks - 1).  Plans are group-independent,
        so a G2 engine given these plans runs the same grouping."""
        c = c or self.window_bits_for(n)
        w = num_windows(c)
        out = dict(n=n, c=c, w=w)
        ch = self._chunk_for(n)
        if ch is None and n < self.tile_threshold:
            return dict(out, mode="small", seg_steps=max(1, (n - 1).bit_length()))
        span = ch or n
        chunks = -(-n // span)
        wg = self._group_size(span, w)
        wpad = (-w) % wg
        k, m = self._tile_split(span)
        p_cap = self._p_cap(span, c)
        return dict(out, mode="chunk" if ch else "tiled", span=span, chunks=chunks, wg=wg, wpad=wpad,
                    groups=(w + wpad) // wg, k=k, m=m, p_cap=p_cap,
                    seg_steps=max(1, (p_cap - 1).bit_length()), badds=chunks - 1)

    def _false(self):
        return torch.zeros((), dtype=torch.bool, device=self.device)

    def _badd(self, a, b):
        """a + b laneswise on K1's per-lane add, with any lane's flag (the
        complete form's flag is constant False): the cross-chunk bucket add."""
        if self.complete:
            return self.bg.jadd(a, b), self._false()
        pt, bad = self.bg.jadd_flagged(a, b)
        return pt, bad.any()

    # ------------------------------------------------------------------
    # device pipeline
    # ------------------------------------------------------------------
    def _plan_impl(self, dig_g: torch.Tensor, c: int) -> dict:
        """Sort/compaction plan for one window group of SIGNED digits
        (wg, N): everything data-dependent that does not involve points."""
        wg, n = dig_g.shape
        k, m = self._tile_split(n)
        mag = dig_g.abs()
        smag, order = torch.sort(mag, dim=1, stable=True)
        sneg = torch.gather(dig_g, 1, order) < 0
        # sorted position t*K + j  ->  scan step j, lane (w, t)
        ord3 = order.reshape(wg, m, k).permute(2, 0, 1).contiguous()  # (K, Wg, m)
        mag3 = smag.reshape(wg, m, k).permute(2, 0, 1).contiguous()
        neg3 = sneg.reshape(wg, m, k).permute(2, 0, 1).contiguous()
        # a partial emitted at step j is FINAL iff step j+1 (same tile)
        # opens a new run, or j == K-1
        nxt = torch.cat([mag3[1:], torch.full((1, wg, m), -8, dtype=mag3.dtype, device=mag3.device)])
        closed = nxt != mag3  # (K, Wg, m)
        flat_closed = closed.permute(1, 2, 0).reshape(wg, n)
        p_cap = self._p_cap(n, c)
        pos = torch.cumsum(flat_closed.to(torch.int32), dim=1, dtype=torch.int32) - 1
        idx_flat = torch.where(flat_closed, pos, torch.full_like(pos, p_cap))
        idx3 = idx_flat.reshape(wg, m, k).permute(2, 0, 1).long().contiguous()
        widx = torch.arange(wg, device=dig_g.device).view(1, wg, 1).expand_as(idx3)
        comp_dig = torch.full((wg, p_cap + 1), -3, dtype=torch.int32, device=dig_g.device)
        comp_dig[widx, idx3] = mag3
        return {
            "ord3": ord3,
            "mag3": mag3,
            "neg3": neg3,
            "idx3": idx3,
            "comp_dig": comp_dig[:, :p_cap].contiguous(),
        }

    def _apply_impl(self, points, plan: dict, c: int):
        """Apply a group plan to an affine point set: tiled accumulation
        (K steps of wide mixed adds with sign folding) and compaction, then
        the segmented merge scan.  Returns (buckets, bad) with bucket leaves
        (8, Wg, m_buckets)."""
        m_buckets, _ = bucket_count(c)
        comp_pts, bad = _mk.apply(points, plan, self.bg._arity, self.complete)
        scanned, bad2 = self._seg_scan_runs(comp_pts, plan["comp_dig"])
        return self._runs_to_buckets(scanned, plan["comp_dig"], m_buckets), bad | bad2

    def _seg_scan_runs(self, pts, sdig):
        """Segmented Hillis-Steele inclusive scan over contiguous runs of
        equal ``sdig`` along the LAST axis.  Negative digits are sentinels.
        Returns (scanned, bad)."""
        return _mk.seg_scan(pts, sdig, self.bg._arity, self.complete)

    @staticmethod
    def _runs_to_buckets(acc, sdig, m_buckets: int):
        """Scatter each run's tail element into its bucket slot.
        acc leaves (8, Wg, P) [or (8, P)], sdig (Wg, P) [or (P,)]."""
        nxt = torch.cat(
            [sdig[..., 1:], torch.full(sdig.shape[:-1] + (1,), -2, dtype=sdig.dtype, device=sdig.device)],
            dim=-1,
        )
        is_last = torch.logical_and(sdig != nxt, sdig >= 0)
        slot = torch.where(is_last, sdig, torch.full_like(sdig, m_buckets)).long()
        if sdig.dim() == 1:

            def scatter(c_):
                out = torch.zeros((c_.shape[0], m_buckets + 1), dtype=c_.dtype, device=c_.device)
                out[:, slot] = c_
                return out[:, :m_buckets].contiguous()

            return tree_map(scatter, acc)
        wg = sdig.shape[0]
        widx = torch.arange(wg, device=sdig.device).view(wg, 1).expand_as(slot)

        def scatter2(c_):
            out = torch.zeros((c_.shape[0], wg, m_buckets + 1), dtype=c_.dtype, device=c_.device)
            out[:, widx, slot] = c_
            return out[:, :, :m_buckets].contiguous()

        return tree_map(scatter2, acc)

    def _plan_small_impl(self, digits: torch.Tensor) -> dict:
        """Small-N plan: one sort over the raw (signed) digit matrix."""
        mag = digits.abs()
        smag, order = torch.sort(mag, dim=1, stable=True)
        sneg = torch.gather(digits, 1, order) < 0
        return {"order": order, "smag": smag, "sneg": sneg}

    def _apply_small_impl(self, points, plan: dict, c: int):
        """Small-N path: all windows in lanes, one gather + one segmented
        scan over the raw sorted stream, reduction included.  Returns
        (window_sums, bad)."""
        m_buckets, _ = bucket_count(c)
        order, smag = plan["order"], plan["smag"]
        w, n = order.shape
        flat = order.reshape(-1)
        spts = tree_map(
            lambda c_: c_.index_select(1, flat).reshape(LIMBS, w, n), points
        )
        spts = _mk.neg_y_where(spts, plan["sneg"], self.bg._arity)
        scanned, bad = self._seg_scan_runs(spts, smag)
        buckets = self._runs_to_buckets(scanned, smag, m_buckets)
        sums, bad2 = self._reduce_buckets(buckets, c)
        return sums, bad | bad2

    def _reduce_buckets(self, buckets, c: int):
        """Σ_b b·B_b per window, parallel: chunk b = q·D + j, run the
        double-running-sum over j only (D steps, W·Q-wide lanes), then
        combine the Q chunk aggregates with a second Q-step scan:
        Σ_b b·B_b = D·Σ_q q·S_q + Σ_q T_q.  buckets leaves (8, W, M);
        returns (sums, bad) with sum leaves (8, W)."""
        _, d_chunk = bucket_count(c)
        return _mk.reduce(buckets, d_chunk, self.bg._arity, self.complete)

    # ------------------------------------------------------------------
    # eager pipeline: plans, then window sums
    # ------------------------------------------------------------------
    def make_plans(self, limbs, c: int, n_lanes: Optional[int] = None) -> dict:
        """Build the device-resident sort/compaction plans for a scalar
        vector (8, N): one plan per window group (``"tiled"``), or per
        window group of each chunk (``"chunk"``: ``chunks`` holds a list of
        group plans per chunk, the limbs zero-padded to a multiple of the
        ``span``).  The result can be passed to ``window_sums_eager`` of
        ANY engine (plans contain no point or group data), so the prover's
        three same-witness MSMs — G2 included — pay the sort once."""
        n = int(limbs.shape[1]) if n_lanes is None else n_lanes
        assert limbs.shape[1] == n, (limbs.shape, n)
        return self._plans(limbs, c, n, self._chunk_for(n))

    def _plans(self, limbs, c: int, n: int, ch: Optional[int]) -> dict:
        """:meth:`make_plans` with the chunk width given (None: unchunked)."""
        if ch is None and n < self.tile_threshold:
            digits = signed_digits_from_limbs(limbs, c)
            return {"mode": "small", "c": c, "n": n, "plan": self._plan_small_impl(digits)}
        span_ = ch or n
        w = num_windows(c)
        wg = self._group_size(span_, w)
        wpad = (-w) % wg
        pad = (-n) % span_
        if pad:
            limbs = torch.nn.functional.pad(limbs, (0, pad))
        chunks = []
        for c0 in range(0, n + pad, span_):
            digits = signed_digits_from_limbs(limbs[:, c0 : c0 + span_], c)
            if wpad:
                digits = torch.cat([digits, digits.new_zeros((wpad, span_))])
            chunks.append([self._plan_impl(digits[g0 : g0 + wg], c) for g0 in range(0, w + wpad, wg)])
        if ch is None:
            return {"mode": "tiled", "c": c, "n": n, "wg": wg, "wpad": wpad, "plans": chunks[0]}
        return {"mode": "chunk", "c": c, "n": n, "span": span_, "wg": wg, "wpad": wpad, "chunks": chunks}

    def window_sums_eager(self, aff_points, limbs, c: int, plans=None):
        """Affine point pytree (N lanes) + (8, N) scalar limbs ->
        (window sums, bad flag), sum leaves (8, W).  ``plans`` (from
        :meth:`make_plans`, possibly of another engine) skips the digit and
        sort work.  On a chunk plan the points are zero-padded to the span,
        each chunk's groups are applied and merged, and the chunks' buckets
        are added (``badd``) before the one reduction.

        Each phase of the tiled and chunk paths is a span (``msm.plan``,
        ``msm.apply+badd``, ``msm.reduce``: :mod:`..profiling`).  With
        ``GOSNARK_MSM_PROFILE=1`` each ends in a fence, which changes the
        asynchronous dispatch; with ``events`` none does, and each gets its
        stream time from two CUDA events."""
        n = tree_leaves(aff_points)[0].shape[-1]
        if plans is None:
            with span("msm.plan", self.device, when=n >= self.tile_threshold):
                plans = self.make_plans(limbs, c, n)
        else:
            assert plans["c"] == c and plans["n"] == n, (plans["c"], plans["n"], c, n)
        if plans["mode"] == "small":
            return self._apply_small_impl(aff_points, plans["plan"], c)
        chunks = plans["chunks"] if plans["mode"] == "chunk" else [plans["plans"]]
        span_ = plans.get("span", n)
        buckets, bad = None, self._false()
        with span("msm.apply+badd", self.device):
            for ci, group_plans in enumerate(chunks):
                pts = aff_points
                if len(chunks) > 1 or span_ != n:
                    pts = tree_map(lambda c_: self._chunk_of(c_, ci * span_, span_), aff_points)
                parts = []
                for plan in group_plans:
                    b_g, f_g = self._apply_impl(pts, plan, c)
                    parts.append(b_g)
                    bad = bad | f_g
                b = parts[0] if len(parts) == 1 else tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)
                if buckets is None:
                    buckets = b
                else:
                    buckets, f_b = self._badd(buckets, b)
                    bad = bad | f_b
        with span("msm.reduce", self.device):
            sums, f_r = self._reduce_buckets(buckets, c)
        if plans["wpad"]:
            sums = tree_map(lambda c_: c_[:, : num_windows(c)].contiguous(), sums)
        return sums, bad | f_r

    @staticmethod
    def _chunk_of(leaf: torch.Tensor, c0: int, span_: int) -> torch.Tensor:
        """Lanes [c0, c0 + span) of a point leaf, zero-padded past its end
        (zero lanes are identities), as a contiguous tensor."""
        part = leaf[..., c0 : c0 + span_]
        if part.shape[-1] < span_:
            return torch.nn.functional.pad(part, (0, span_ - part.shape[-1]))
        return part.contiguous()

    def window_sums_device(self, aff_points, limbs, c: int):
        """The JAX engine's whole-MSM device entry: affine points + (8, N)
        scalar limbs -> (window sums, bad).  Unchunked whatever the
        engine's chunk setting, as the JAX entry is (its traced form runs
        the per-shape pipeline)."""
        n = tree_leaves(aff_points)[0].shape[-1]
        return self.window_sums_eager(aff_points, limbs, c, self._plans(limbs, c, n, None))

    # ------------------------------------------------------------------
    def fallback_engine(self) -> "MSMEngine":
        """The complete-formula twin used when a degeneracy flag fires: a
        copy of this engine (its layout, and a subclass's own state such as
        a mesh) with ``complete=True`` and counters of its own."""
        if self.complete:
            return self
        if self._fallback is None:
            twin = copy.copy(self)
            twin.complete, twin.fallback_hits = True, 0
            self._fallback = twin
        return self._fallback

    def rerun_if_flagged(self, sums, bad, redo):
        """The exact result of an MSM run on this engine that gave ``sums``
        and the degeneracy flag ``bad`` (a sharded caller's already ORed
        over the ranks): when the flag fired, read here where the host waits
        for the device, ``redo(engine)`` runs the MSM again on the
        complete-formula twin and its result is returned.  Each re-run
        counts one in ``fallback_hits``.  A complete engine reads no flag."""
        if self.complete or not bool(bad):
            return sums
        self.fallback_hits += 1
        return redo(self.fallback_engine())

    def window_sums_checked(self, aff_points, limbs, c: int, plans=None):
        """window_sums_eager + host flag check + automatic complete-formula
        re-run.  Returns window sums only (exactly correct).  The flag read,
        where the host waits for the card, and the re-run are the
        ``msm.flags`` span."""
        sums, bad = self.window_sums_eager(aff_points, limbs, c, plans)
        with span("msm.flags", self.device, when=not self.complete):
            return self.rerun_if_flagged(
                sums, bad, lambda eng: eng.window_sums_eager(aff_points, limbs, c, plans)[0])

    def msm_device(self, dev_points, limbs):
        """Jacobian point pytree + scalar limbs -> one host Jacobian point:
        affine-normalise, window sums (with the degeneracy fallback), exact
        host combination."""
        n = tree_leaves(dev_points)[0].shape[-1]
        c = self.window_bits_for(n)
        aff = self.bg.to_affine(dev_points)
        sums = self.window_sums_checked(aff, limbs, c)
        return combine_window_sums(self.host_group, self.bg.unpack(sums), c)

    def msm(self, host_points, host_scalars: Sequence[int]):
        """Σ sᵢ·Pᵢ.  host_points: reference-style Jacobian points; returns
        one host Jacobian point."""
        assert len(host_points) == len(host_scalars)
        n = len(host_points)
        if n == 0:
            return self.host_group.zero()
        pad = (-n) % self.pad_quantum(n)
        pts = list(host_points) + [self.host_group.zero()] * pad
        scs = [s % self.r for s in host_scalars] + [0] * pad
        dev_pts = self.bg.pack(pts)
        limbs = scalars_to_limbs(scs, self.r, self.device)
        return self.msm_device(dev_pts, limbs)
