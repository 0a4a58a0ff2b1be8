"""The multi-device Groth16 prover.

Counterpart of ``go_snark_study_tpu/parallel/sharded_prover.py``, one
process per rank:

  * **ShardedDevicePk** — each rank packs and affine-normalises (K2) only
    its own slice of the host-materialised proving key, once, identity
    padded to ``local`` lanes, and keeps it on its device (cached on the
    ``Pk``).
  * **the rank's pipeline** — a shard runs ``make_plans`` /
    ``window_sums_eager`` of :class:`..ops.msm.MSMEngine` (K1's forms) over
    its ``local`` lanes: in the chunks of ``_chunk_for(local)`` when the
    engine is chunked (the key slice padded to the chunk through
    ``pad_quantum``), as the JAX package's sharded pieces are, else
    unchunked.  The witness plan is built once per proof and shared by the
    At / BACGamma-G1 / BACGamma-G2 MSMs.
  * **combine** — each rank's W window sums are fetched with
    ``all_gather`` and added on the host in rank order d = 0..D-1, so every
    rank assembles the same proof.
  * **H(x)** — as in JAX, the single-device coset pipeline: every rank runs
    it whole and takes its slice of the H digits, so no collective is
    needed and the values are the same everywhere.

Degeneracy flags are ORed across ranks before the complete-formula re-run,
so every rank re-runs together.

``rng`` must be in the same state on every rank (it draws r and s): ranks
seeded alike return the same proof.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bn128 import constants as C
from ..models.groth16 import Pk, Proof
from ..ops.curve_ops import tree_leaves
from ..ops.limbs import bytes_to_limbs
from ..ops.msm import MSMEngine, bucket_count, combine_window_sums, num_windows, scalars_to_limbs
from .mesh import Mesh, all_gather, any_rank
from .sharded_msm import _unflatten

__all__ = ["ShardedDevicePk", "ShardedFastProver", "dry_shape_check"]


def dry_shape_check(n_log2: int = 22, mesh_shape=(2, 8)) -> dict:
    """The sharded MSM layout at a tier beyond the hardware at hand (the
    2^22 mul-chain instance on a (host, data) = (2, 8) grid by default),
    for the JAX package's accelerator configuration (an engine with
    ``chunk_lanes=1 << 17, small_chunk_lanes=1 << 14``), computed from the
    engine's rules without allocating a tensor or needing a rank.  The
    dict is the JAX function's, key for key (:func:`_dry_shape`)."""
    eng = MSMEngine(None, None, C.R, chunk_lanes=1 << 17, small_chunk_lanes=1 << 14)
    return _dry_shape(eng, n_log2, mesh_shape)


def _dry_shape(eng: MSMEngine, n_log2: int, mesh_shape) -> dict:
    """JAX's ``dry_shape_check`` rule on a chunked engine (its lane and
    window rules need no group): lanes per shard (the tier's signals over
    the devices, rounded up to the chunk), chunks per shard, window width
    (``window_bits_for``), windows, buckets per window (``bucket_count``)
    and the compaction width of a chunk's plan (``_plan_impl``'s
    ``p_cap`` at the chunk width)."""
    d = 1
    for s in mesh_shape:
        d *= int(s)
    m = (1 << n_log2) + 3  # signals of the mul-chain tier instance
    ch = eng.chunk_lanes
    per = -(-m // d)
    local = -(-per // ch) * ch
    c = eng.window_bits_for(local)
    w = num_windows(c)
    m_buckets, _ = bucket_count(c)
    return {
        "tier": f"2^{n_log2}",
        "mesh": dict(zip(("host", "data"), mesh_shape)),
        "devices": d,
        "local_lanes": local,
        "chunks_per_shard": local // ch,
        "window_bits": c,
        "windows": w,
        "buckets_per_window": m_buckets,
        "plan_p_cap": eng._p_cap(ch, c),
        "ok": True,
    }


@dataclass
class ShardedDevicePk:
    """This rank's slice of the proving key: affine leaves (8, local)."""

    n: int
    m: int
    lo: int
    local_m: int  # per-shard lanes of at/b1/b2
    local_mp: int  # per-shard lanes of cdelta
    local_n: int  # per-shard lanes of ptau
    at: object = None
    b1: object = None
    b2: object = None
    cdelta: object = None
    ptau: object = None


class ShardedFastProver:
    """Multi-device prover bound to one mesh; engines shared with the
    ``FastGroth16`` it wraps, which must live on the mesh's device type."""

    def __init__(self, fast, mesh: Mesh):
        if fast.device.type != mesh.device.type:
            raise ValueError(f"prover on {fast.device}, mesh on {mesh.device}")
        self.fast = fast
        self.mesh = mesh
        self.ndev = mesh.size()
        self.rank = mesh.my_rank()

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------
    def _local_lanes(self, n: int, eng) -> int:
        per = -(-n // self.ndev)
        q = eng.pad_quantum(per)
        return -(-per // q) * q

    def _my_points(self, bg, host_pts, local: int):
        """This rank's slice of host Jacobian points -> affine leaves
        (8, local), identity-padded (absorbed by the branchless law)."""
        lo = self.rank * local
        pts = list(host_pts[lo : lo + local])
        zero = (0, 0, 0) if bg._arity == 1 else ((0, 0), (0, 0), (0, 0))
        pts += [zero] * (local - len(pts))
        return bg.to_affine(bg.pack(pts))

    def shard_pk(self, pk: Pk, n: int, lo: int) -> ShardedDevicePk:
        """This rank's slice of the device key, from a host-materialised
        Pk; built once and cached on the Pk."""
        cached = getattr(pk, "_sharded", None)
        if cached is not None and cached[0] is self.mesh:
            return cached[1]
        g1b, g2b = self.fast.g1b, self.fast.g2b
        eng = self.fast.msm_g1
        m = len(pk.g1.at)
        local_m = self._local_lanes(m, eng)
        local_mp = self._local_lanes(m - lo, eng)
        local_n = self._local_lanes(n, eng)
        spk = ShardedDevicePk(
            n=n,
            m=m,
            lo=lo,
            local_m=local_m,
            local_mp=local_mp,
            local_n=local_n,
            at=self._my_points(g1b, pk.g1.at, local_m),
            b1=self._my_points(g1b, pk.g1.bacgamma, local_m),
            b2=self._my_points(g2b, pk.g2.bacgamma, local_m),
            cdelta=self._my_points(g1b, pk.bacdelta[lo:], local_mp),
            ptau=self._my_points(g1b, pk.powers_tau_delta[:n], local_n),
        )
        pk._sharded = (self.mesh, spk)
        return spk

    def shard_scalars(self, scalars, local: int) -> torch.Tensor:
        """Field scalars -> this rank's (8, local) limbs, zero padded."""
        lo = self.rank * local
        mine = list(scalars[lo : lo + local])
        return scalars_to_limbs(mine + [0] * (local - len(mine)), C.R, self.fast.device)

    def shard_bytes(self, buf: bytes, local: int, first: int = 0) -> torch.Tensor:
        """Canonical 32-byte values (``SparseR1CS._row_evals_bytes``) ->
        this rank's (8, local) plain limbs, values ``first + rank * local``
        on, zero padded."""
        lo = 32 * (first + self.rank * local)
        return bytes_to_limbs(buf[lo : lo + 32 * local], self.fast.device, local)

    def _my_rows(self, rows: torch.Tensor, local: int) -> torch.Tensor:
        """(8, n) limbs -> this rank's (8, local) columns, zero padded."""
        lo = min(self.rank * local, rows.shape[1])
        mine = rows[:, lo : lo + local]
        return torch.nn.functional.pad(mine, (0, local - mine.shape[1])).contiguous()

    def window_sums(self, eng, points, plans: dict):
        """This rank's pipeline -> (host window-sum points of the whole
        mesh, whether any rank's flag fired).  Each rank's (8, W) sums are
        gathered (a few KB) and added on the host in rank order."""
        sums, bad = eng.window_sums_eager(points, None, plans["c"], plans)
        group = self.mesh.flat_group
        gathered = [all_gather(leaf, group) for leaf in tree_leaves(sums)]
        bad = any_rank(bad, group, self.fast.device)
        host = eng.host_group
        combined = None
        for d in range(self.ndev):
            pts = eng.bg.unpack(_unflatten(sums, [g[d] for g in gathered]))
            combined = pts if combined is None else [host.add(x, y) for x, y in zip(combined, pts)]
        return combined, bad

    def _msm(self, eng, points, plans: dict):
        pts, bad = self.window_sums(eng, points, plans)
        if bad and not eng.complete:
            eng.fallback_hits += 1
            pts, _ = self.window_sums(eng.fallback_engine(), points, plans)
        return combine_window_sums(eng.host_group, pts, plans["c"])

    # ------------------------------------------------------------------
    def prove(self, r1cs, pk: Pk, rng=None) -> Proof:
        """Same proof assembly as FastGroth16.prove (groth16.go:225-279);
        the five MSMs run data-parallel over the mesh from this rank's
        slice of the key."""
        from ..models.groth16_fast import _next_pow2

        fast = self.fast
        ctx = fast.ctx
        r = C.R
        g1, g2 = ctx.bn.g1, ctx.bn.g2
        n = _next_pow2(r1cs.n_constraints)
        lo = r1cs.n_public + 1
        spk = self.shard_pk(pk, n, lo)
        eng1, eng2 = fast.msm_g1, fast.msm_g2

        r_rand = ctx.rand_fr(rng)
        s_rand = ctx.rand_fr(rng)

        # window widths follow the LOCAL lane count, the pipeline each
        # shard actually runs
        c_m = eng1.window_bits_for(spk.local_m)
        c_p = eng1.window_bits_for(spk.local_mp)
        c_h = eng1.window_bits_for(spk.local_n)

        # the witness and the row evaluations cross as bytes, as in prove
        a_b, b_b, c_b, w_b = r1cs._row_evals_bytes()
        w_limbs = self.shard_bytes(w_b, spk.local_m)
        wp_limbs = self.shard_bytes(w_b, spk.local_mp, first=lo)
        plans_w = eng1.make_plans(w_limbs, c_m)
        plans_p = eng1.make_plans(wp_limbs, c_p)

        pi_a = self._msm(eng1, spk.at, plans_w)
        pi_b_g1 = self._msm(eng1, spk.b1, plans_w)
        pi_b = self._msm(eng2, spk.b2, plans_w)
        pi_c = self._msm(eng1, spk.cdelta, plans_p)

        # H(x) via the single-device coset pipeline on every rank, then this
        # rank's slice of the H digits for the ptau MSM
        h_in = [fast.Kr.pack_bytes(v, lanes=n) for v in (a_b, b_b, c_b)]
        h_digits = fast._get_h_jit(n, n)(*h_in, *fast._ntt_args(n))
        h_mine = self._my_rows(h_digits, spk.local_n)
        plans_h = eng1.make_plans(h_mine, c_h)
        pi_h = self._msm(eng1, spk.ptau, plans_h)

        pi_a = g1.add(pi_a, pk.g1.alpha)
        pi_a = g1.add(pi_a, g1.mul_scalar(pk.g1.delta, r_rand))
        pi_b_g1 = g1.add(pi_b_g1, pk.g1.beta)
        pi_b = g2.add(pi_b, pk.g2.beta)
        pi_b_g1 = g1.add(pi_b_g1, g1.mul_scalar(pk.g1.delta, s_rand))
        pi_b = g2.add(pi_b, g2.mul_scalar(pk.g2.delta, s_rand))

        pi_c = g1.add(pi_c, pi_h)
        pi_c = g1.add(pi_c, g1.mul_scalar(pi_a, s_rand))
        pi_c = g1.add(pi_c, g1.mul_scalar(pi_b_g1, r_rand))
        neg_rs = (-(r_rand * s_rand)) % r
        pi_c = g1.add(pi_c, g1.mul_scalar(pk.g1.delta, neg_rs))
        return Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)

