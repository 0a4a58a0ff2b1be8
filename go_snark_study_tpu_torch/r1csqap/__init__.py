"""Polynomial field + QAP transforms of the parity path.

Mirrors ``go_snark_study_tpu/r1csqap/__init__.py``.  ``polynomial`` is the
exact host parity path (reference: r1csqap/r1csqap.go); ``float_qap`` is
the didactic float twin (reference: r1csqapFloat/).
"""

from .polynomial import PolynomialField, array_of_zeros, arrays_equal, transpose

__all__ = ["PolynomialField", "array_of_zeros", "arrays_equal", "transpose"]
