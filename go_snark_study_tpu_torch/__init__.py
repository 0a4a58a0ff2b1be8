"""PyTorch/CUDA port of the Groth16 fast path of ``go_snark_study_tpu``.

``models.groth16_fast.FastGroth16`` sets up and proves on one NVIDIA card,
and ``models.groth16.verify_proof`` checks the proof on the host.  Under it
are four hand-written CUDA kernels (``csrc/``): K1 point add, K2 Montgomery
product, K3 small column NTT, K4 radix-2 butterfly, each with a plain
PyTorch version beside it in ``ops/``.  Entry points take ``device=None``,
meaning the card, and raise without one; ``device="cpu"`` runs the plain
versions.  The package imports neither ``jax`` nor the JAX package.
"""
