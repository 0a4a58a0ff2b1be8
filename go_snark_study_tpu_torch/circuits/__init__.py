"""Circuits written for the fast prover: each module builds a
:class:`..synthetic.SparseR1CS` and computes its witness.

* :mod:`.sha256`: circomlib's SHA-256 (``Sha256(nBits)``) over a message of
  whole bytes, each byte range-checked by ``Num2Bits(8)``, the digest bits
  public.
"""
