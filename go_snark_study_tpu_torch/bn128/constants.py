"""BN128 (alt_bn128 / BN254) curve constants.

Copy of ``go_snark_study_tpu/bn128/constants.py``, unchanged: the port keeps
its own copy so that importing it never imports the JAX package.

Values match the reference's ``NewBn128``/``preparePairing``
(bn128/bn128.go:38-176) and the public alt_bn128 parameterisation:

  * q — base-field modulus (bn128.go:40)
  * r — scalar-field ("Fr") modulus (bn128.go:46); note r-1 = 2^28 * odd,
    which is what makes radix-2 NTTs over Fr possible up to 2^28 points.
  * curve parameter u with q = 36u^4+36u^3+24u^2+6u+1 and the optimal-ate
    loop count 6u+2 (bn128.go:122).
  * FINAL_EXP — the full (q^12-1)/r exponent the reference hard-codes
    (bn128.go:169); we *derive* it and assert it equals the published value.
"""

from __future__ import annotations

# base field modulus
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# scalar field modulus (group order of G1/G2)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter u: q(u) = 36u^4 + 36u^3 + 24u^2 + 6u + 1
U = 4965661367192848881
assert 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1 == Q
assert 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1 == R

# optimal-ate Miller loop count 6u+2 (bn128.go:122)
LOOP_COUNT = 6 * U + 2
assert LOOP_COUNT == 29793968203157093288
LOOP_COUNT_NEG = False

# G1 generator (1, 2) (bn128.go:52-55)
G1_GENERATOR = (1, 2)

# G2 generator over Fq2 (bn128.go:57-83)
G2_GENERATOR = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# tower non-residues (bn128.go:86-93): Fq2 = Fq[u]/(u^2 + 1), i.e. beta = -1;
# Fq6 = Fq2[v]/(v^3 - xi) with xi = 9 + u.
NON_RESIDUE_FQ2 = Q - 1
NON_RESIDUE_FQ6 = (9, 1)

# scalar-field 2-adicity: r - 1 = 2^TWO_ADICITY * odd
TWO_ADICITY = (R - 1 & -(R - 1)).bit_length() - 1
assert TWO_ADICITY == 28
# 5 is the smallest generator of Fr*; fixed primitive 2^28-th root of unity
ROOT_OF_UNITY = pow(5, (R - 1) >> TWO_ADICITY, R)

# full final-exponentiation exponent (q^12 - 1) / r; the reference hard-codes
# the decimal expansion (bn128.go:169) — we derive it instead and the test
# suite asserts equality with that constant.
FINAL_EXP = (Q**12 - 1) // R
