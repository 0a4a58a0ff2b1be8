"""The benchmark of the PyTorch and CUDA port (``go_snark_study_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Cells,
configurations, traffic mixes and metrics are files found by name (see
:mod:`benchmark.spec`); :mod:`benchmark.reference` decides ``correct``;
:mod:`benchmark.cost` is the yardstick of work; :mod:`benchmark.control`
runs the control.  Nothing here imports ``jax`` or the JAX package.
"""
