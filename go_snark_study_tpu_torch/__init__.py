"""PyTorch/CUDA port of ``go_snark_study_tpu``.

``models.groth16_fast.FastGroth16`` sets up and proves on one NVIDIA card,
and ``models.groth16.verify_proof`` checks the proof on the host.  Under it
are four hand-written CUDA kernels (``csrc/``): K1 point add, K2 Montgomery
product, K3 small column NTT, K4 radix-2 NTT, each with a plain
PyTorch version beside it in ``ops/``.  The flat-code circuit compiler
(``circuitcompiler``, ``r1csqap``, ``api``) feeds both the fast prover
(``synthetic.SparseR1CS.from_circuit``) and the parity-path Groth16 and
Pinocchio protocols, whose MSMs and fixed-base commitments
``models.accel`` sends to the card.  Entry points take ``device=None``,
meaning the card, and raise without one; ``device="cpu"`` runs the plain
versions.  The package imports neither ``jax`` nor the JAX package.
"""
