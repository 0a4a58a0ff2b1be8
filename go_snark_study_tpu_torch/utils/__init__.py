"""Serialization: the reference wire formats.

Copy of ``go_snark_study_tpu/utils/__init__.py``.

``base10`` / ``hexcodec`` — the decimal and hex string dialects
(utils/base10parsers.go, utils/hexparsers.go); ``raw`` — Go's
json.Marshal-of-big.Int numeric dialect used by the reference CLI's
compiledcircuit.json / trustedsetup.json / proofs.json files.
"""

from .serializers import Codec

base10 = Codec(10)
hexcodec = Codec(16)
raw = Codec(0)

__all__ = ["Codec", "base10", "hexcodec", "raw"]
