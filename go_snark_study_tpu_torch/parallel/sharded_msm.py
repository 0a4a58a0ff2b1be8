"""Data-parallel Pippenger MSM over the ranks of a mesh.

Counterpart of ``go_snark_study_tpu/parallel/sharded_msm.py``.  Points and
scalars are split along the batch axis; every rank packs only its slice and
runs the whole local pipeline on it (``to_affine`` on K2, then
``window_sums_device``: plan, K1's apply, merge-scan and reduce forms,
unchunked whatever the engine's chunk setting, as JAX's traced local
program is), producing per-rank window sums.  Window sums are points, so the combine is
an ``all_gather`` followed by a log-depth tree of complete Jacobian adds
(K1's per-lane form), pairing parts (0, 1), (2, 3), ... as JAX does, so
the sums are JAX's coordinate for coordinate.  On the 2-D ("host", "data")
mesh the "data" axis is combined first and "host" last, so one window-sum
payload per host crosses hosts.

Any rank's degeneracy flag poisons the whole result: the flags are ORed
over the mesh (``all_reduce`` MAX), and when one fired EVERY rank re-runs
through the complete-formula twin, since a collective must be entered by
all ranks.

Every rank calls :meth:`ShardedMSMEngine.msm` with the same host points
and scalars and gets the same point back.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.curve_ops import tree_leaves, tree_map
from ..ops.msm import MSMEngine, combine_window_sums, scalars_to_limbs
from .mesh import Mesh, all_gather, any_rank

__all__ = ["ShardedMSMEngine"]


def _unflatten(like, leaves):
    """A point pytree shaped as ``like`` with ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class ShardedMSMEngine(MSMEngine):
    """MSMEngine whose pipeline runs on every rank of ``mesh``, each over
    its own slice of the lanes."""

    def __init__(self, batch_group, host_group, scalar_modulus: int, mesh: Mesh, **kw):
        super().__init__(batch_group, host_group, scalar_modulus, **kw)
        self.mesh = mesh
        self.axes = mesh.axis_names

    def gather_parts(self, sums, axis: str) -> list:
        """Every rank's window sums on ``axis``, in the axis's rank order
        (``all_gather``; leaves (8, W))."""
        group = self.mesh.get_group(axis)
        gathered = [all_gather(leaf, group) for leaf in tree_leaves(sums)]
        return [_unflatten(sums, [g[i] for g in gathered]) for i in range(self.mesh.axis_size(axis))]

    def _gather_tree_add(self, sums, axis: str):
        """all_gather window sums over ``axis``, combine with a log-depth tree
        of complete Jacobian adds (leaves (8, W) on every rank)."""
        parts = self.gather_parts(sums, axis)
        while len(parts) > 1:
            nxt = [self.bg.jadd(parts[i], parts[i + 1]) for i in range(0, len(parts) - 1, 2)]
            if len(parts) % 2:
                nxt.append(parts[-1])
            parts = nxt
        return parts[0]

    def window_sums_sharded(self, points, limbs, c: int):
        """This rank's Jacobian points and (8, local) scalar limbs -> (the
        mesh's window sums, leaves (8, W), the same on every rank; whether
        any rank's flag fired)."""
        aff = self.bg.to_affine(points)
        sums, bad = self.window_sums_device(aff, limbs, c)
        bad = any_rank(bad, self.mesh.flat_group, self.device)
        for ax in reversed(self.axes):  # innermost axis first, outer last
            sums = self._gather_tree_add(sums, ax)
        return sums, bad

    def fallback_engine(self) -> "ShardedMSMEngine":
        if self.complete:
            return self
        if self._fallback is None:
            self._fallback = ShardedMSMEngine(
                self.bg,
                self.host_group,
                self.r,
                self.mesh,
                window_bits=self.window_bits,
                tile_threshold=self.tile_threshold,
                tile_steps=self.tile_steps,
                tile_lanes=self.tile_lanes,
                group_bytes=self.group_bytes,
                chunk_lanes=self.chunk_lanes,
                small_chunk_lanes=self.small_chunk_lanes,
                small_chunk_max=self.small_chunk_max,
                complete=True,
            )
        return self._fallback

    def pack_share(self, host_points, host_scalars: Sequence[int]):
        """This rank's share of an n-point MSM, every rank's an equal
        multiple of the lane quantum, identity- and zero-padded: (Jacobian
        points, (8, local) scalar limbs, window width)."""
        n = len(host_points)
        ndev = self.mesh.size()
        quantum = self.pad_quantum(max(1, n // ndev)) * ndev
        local = (n + (-n) % quantum) // ndev
        lo = self.mesh.my_rank() * local
        pts = list(host_points[lo : lo + local])
        scs = [s % self.r for s in host_scalars[lo : lo + local]]
        pad = local - len(pts)
        pts += [self.host_group.zero()] * pad
        scs += [0] * pad
        return self.bg.pack(pts), scalars_to_limbs(scs, self.r, self.device), self.window_bits_for(local)

    def msm(self, host_points, host_scalars: Sequence[int]):
        """Σ sᵢ·Pᵢ over the mesh; every rank returns the same host point."""
        assert len(host_points) == len(host_scalars)
        if not host_points:
            return self.host_group.zero()
        dev_pts, limbs, c = self.pack_share(host_points, host_scalars)
        sums, bad = self.window_sums_sharded(dev_pts, limbs, c)
        if not self.complete and bad:
            self.fallback_hits += 1
            sums, _ = self.fallback_engine().window_sums_sharded(dev_pts, limbs, c)
        return combine_window_sums(self.host_group, self.bg.unpack(sums), c)
