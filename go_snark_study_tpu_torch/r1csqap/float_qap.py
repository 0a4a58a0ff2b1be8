"""Float-arithmetic QAP twin (didactic).

Copy of ``go_snark_study_tpu/r1csqap/float_qap.py``.

Reference: r1csqapFloat/r1csqapFloat.go — the same R1CS->QAP pipeline over
floating-point numbers so the rational structure of the QAP is visible.  Like
the reference's twin it has no consumers in the library; it exists for study
and for parity with the reference's r1csqapFloat_test.go golden values
(e.g. Z(x) = [24, -50, 35, -10, 1] for n=4 constraints).

Note the twin's own quirk, preserved: here Z(x) has roots 1..nConstraints
(r1csqapFloat.go:136-159), unlike the field version's 1..nSignals-2.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = [
    "transpose",
    "pol_mul",
    "pol_div",
    "pol_add",
    "pol_sub",
    "pol_eval",
    "float_pow",
    "new_pol_zero_at",
    "lagrange_interpolation",
    "r1cs_to_qap",
    "combine_polynomials",
    "divisor_polynomial",
]


def transpose(matrix: Sequence[Sequence[float]]) -> List[List[float]]:
    return [list(col) for col in zip(*matrix)]


def pol_mul(a: Sequence[float], b: Sequence[float]) -> List[float]:
    r = [0.0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            r[i + j] += ai * bj
    return r


def pol_div(a: Sequence[float], b: Sequence[float]) -> Tuple[List[float], List[float]]:
    r = [0.0] * (len(a) - len(b) + 1)
    rem = list(a)
    while len(rem) >= len(b):
        lead = rem[-1] / b[-1]
        pos = len(rem) - len(b)
        r[pos] = lead
        shifted = [0.0] * pos + [lead]
        rem = pol_sub(rem, pol_mul(b, shifted))[:-1]
    return r, rem


def pol_add(a: Sequence[float], b: Sequence[float]) -> List[float]:
    r = [0.0] * max(len(a), len(b))
    for i, ai in enumerate(a):
        r[i] += ai
    for i, bi in enumerate(b):
        r[i] += bi
    return r


def pol_sub(a: Sequence[float], b: Sequence[float]) -> List[float]:
    r = [0.0] * max(len(a), len(b))
    for i, ai in enumerate(a):
        r[i] += ai
    for i, bi in enumerate(b):
        r[i] -= bi
    return r


def float_pow(a: float, e: int) -> float:
    result = 1.0
    for _ in range(e):
        result *= a
    return result


def pol_eval(v: Sequence[float], x: float) -> float:
    return sum(c * float_pow(x, i) for i, c in enumerate(v))


def new_pol_zero_at(point_pos: int, total_points: int, height: float) -> List[float]:
    fac = 1
    for i in range(1, total_points + 1):
        if i != point_pos:
            fac *= point_pos - i
    r = [height / fac]
    for i in range(1, total_points + 1):
        if i != point_pos:
            r = pol_mul(r, [float(-i), 1.0])
    return r


def lagrange_interpolation(v: Sequence[float]) -> List[float]:
    r: List[float] = []
    for i, vi in enumerate(v):
        r = pol_add(r, new_pol_zero_at(i + 1, len(v), vi))
    return r


def r1cs_to_qap(a, b, c):
    at, bt, ct = transpose(a), transpose(b), transpose(c)
    alphas = [lagrange_interpolation(col) for col in at]
    betas = [lagrange_interpolation(col) for col in bt]
    gammas = [lagrange_interpolation(col) for col in ct]
    # float twin convention: roots at 1..nConstraints (r1csqapFloat.go:154-158)
    z = [1.0]
    for i in range(1, len(at[0]) + 1):
        z = pol_mul(z, [float(-i), 1.0])
    return alphas, betas, gammas, z


def combine_polynomials(r, ap, bp, cp):
    ax: List[float] = []
    bx: List[float] = []
    cx: List[float] = []
    for i, ri in enumerate(r):
        ax = pol_add(ax, pol_mul([ri], ap[i]))
        bx = pol_add(bx, pol_mul([ri], bp[i]))
        cx = pol_add(cx, pol_mul([ri], cp[i]))
    px = pol_sub(pol_mul(ax, bx), cx)
    return ax, bx, cx, px


def divisor_polynomial(px, z):
    return pol_div(px, z)[0]
