"""Multi-device proving on ``torch.distributed``: one process per rank.

Counterpart of ``go_snark_study_tpu/parallel/`` (a ``jax.sharding.Mesh``
with ``shard_map`` and XLA collectives under one controller).  Here every
rank runs the same code on the same host inputs, computes its own shard and
returns the same result:

  launch.py          spawn ranks (``run_ranks``), one process each, with the
                     backend the caller names (NCCL, or gloo for the CPU and
                     for several ranks sharing one card)
  mesh.py            device meshes over the ranks (``data_mesh``,
                     ``hier_mesh``) and the collectives the modules use
  sharded_msm.py     data-parallel Pippenger: points split over the ranks,
                     per-rank bucket pipeline, window sums combined with
                     all_gather + tree adds
  sharded_ntt.py     four-step NTT: local row transforms, twiddle scaling,
                     all_to_all transposes
  prover_step.py     the MSM and H(x) phases over a mesh as one step
  sharded_prover.py  the multi-device Groth16 prover (each rank's slice of
                     the key on its device, host combine of window sums)
  scaling.py         weak-scaling report
  checks.py          rank programs that hold the sharded path against the
                     single-device one (the tests, ``chip_smoke.py``)
"""

from .mesh import data_mesh, hier_mesh

__all__ = ["data_mesh", "hier_mesh", "ShardedFastProver"]


def __getattr__(name):
    if name == "ShardedFastProver":
        from .sharded_prover import ShardedFastProver

        return ShardedFastProver
    raise AttributeError(name)
