"""Device meshes over the ranks of a ``torch.distributed`` process group.

Counterpart of ``go_snark_study_tpu/parallel/mesh.py``.  JAX runs one
controller over a ``jax.sharding.Mesh``; the port runs one process per rank
(SPMD, :mod:`.launch`), and a mesh is the layout of those ranks: ranks
0..size-1 in row-major order over the mesh shape, as JAX lays out
``devices[:n].reshape(shape)``.  ``data_mesh`` builds the 1-D ("data",)
layout, ``hier_mesh`` the 2-D ("host", "data") one.  The sharded modules use
only the axis names and the groups behind them.

The groups come from ``torch.distributed.device_mesh.init_device_mesh``,
which gives each axis a group of the default group's backend: NCCL for
CUDA tensors with one rank per card, gloo for CPU tensors and for several
ranks sharing one card (gloo carries CUDA tensors through the host).  Every
collective the sharded modules need (``all_to_all_single``, the list form
of ``all_gather``, ``all_reduce``) takes CUDA tensors on gloo as on NCCL, so
nothing is staged by hand.  Every rank of the world must build every mesh,
in the same order, since making a group is itself a collective.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.limbs import resolve_device

__all__ = ["Mesh", "data_mesh", "hier_mesh", "mesh_for", "all_gather", "all_to_all", "any_rank"]


class Mesh:
    """The ranks 0..size-1 of the world laid out over ``shape``, one axis
    name per dimension.

    ``get_group(axis)`` is the group of this rank along that axis (its
    rank order is the axis order) and ``get_local_rank(axis)`` this rank's
    place in it; ``flat_group`` holds the whole mesh in row-major order (JAX's
    flattened axis tuple), and ``rank`` is this rank's place there, None
    for a rank of the world outside the mesh.  ``device`` is where this
    rank's tensors live: its current card, or the CPU."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device):
        from torch.distributed.device_mesh import init_device_mesh

        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        world, me = dist.get_world_size(), dist.get_rank()
        self.device_mesh = init_device_mesh(dev.type, self.shape, mesh_dim_names=self.axis_names)
        n = self.size()
        self.flat_group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
        self.rank = me if me < n else None

    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def get_group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def get_local_rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def my_rank(self) -> int:
        """This rank's place in the flattened mesh; raises outside it."""
        if self.rank is None:
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh of {self.size()} ranks")
        return self.rank


def _need(n: int, world: int) -> None:
    if world < n:
        raise ValueError(
            f"need {n} devices, have {world} "
            f"(start {n} ranks: parallel.launch.run_ranks(fn, {n}, backend, device_type))"
        )


def data_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (default: all of them)
    named "data".  ``device=None`` is the card; ``"cpu"`` the CPU."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    _need(n, world)
    return Mesh((n,), ("data",), device)


def hier_mesh(n_hosts: int, chips_per_host: Optional[int] = None, device=None) -> Mesh:
    """2-D ("host", "data") mesh for the multi-host tiers: lanes shard over
    the flattened grid, "data"-axis collectives stay within a host and the
    "host"-axis combines carry only window-sum-sized payloads."""
    world = dist.get_world_size()
    if chips_per_host is None:
        if world % n_hosts:
            raise ValueError(f"{world} devices do not split into {n_hosts} hosts")
        chips_per_host = world // n_hosts
    _need(n_hosts * chips_per_host, world)
    return Mesh((n_hosts, chips_per_host), ("host", "data"), device)


def mesh_for(layout, device=None) -> Mesh:
    """``n`` -> ``data_mesh(n)``; ``(hosts, chips)`` -> ``hier_mesh``."""
    if isinstance(layout, int):
        return data_mesh(layout, device)
    hosts, chips = layout
    return hier_mesh(hosts, chips, device)


# ---------------------------------------------------------------------------
# collectives (every rank of ``group`` calls them, in the same order)
# ---------------------------------------------------------------------------
def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t``, in the group's rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    """``chunks[j]`` goes to the group's rank j; returns the chunks received,
    row i from rank i."""
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return out


def any_rank(flag, group, device) -> bool:
    """True on every rank when ``flag`` (a bool, or a bool tensor) holds on
    any rank of the group."""
    t = torch.as_tensor(flag, device=device).to(torch.int32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())
