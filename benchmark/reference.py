"""The plain reference that decides ``correct``: BN254 in Python integers.

Independent of the program: it imports neither ``jax`` nor anything of the
prover's packages, and takes nothing that the program made.  It works out
from the seed's inputs what each answer has to be.

* A G1 multi-scalar multiplication over the points k_i*G is
  (sum_i s_i*k_i mod r)*G, one scalar product.
* A Groth16 proof over the multiplication chain is a closed form in the
  toxic waste (t, alpha, beta, gamma, delta), the blinding pair (r, s) and
  the witness: with a(t) = sum_j a_j L_j(t) for the row values a_j = <A_j, w>
  (and b, c alike) and L_j the Lagrange basis of the 2^k-th roots of unity,

      A = alpha + a(t) + r*delta                                  (G1)
      B = beta + b(t) + s*delta                                   (G2)
      C = (beta*a'(t) + alpha*b'(t) + c'(t) + a(t)*b(t) - c(t)) / delta
          + s*A + r*B - r*s*delta                                 (G1)

  where a'(t) leaves out the public signals' columns.  a(t)b(t) - c(t) is
  H(t)Z(t), so the proof's H term is covered without an NTT.

The control (:func:`control_scalar`) clears the top bit of every scalar at
the width the traffic states: the nearest narrower integer width, the step
a faster scalar path would be tempted to take.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# BN254 (alt_bn128), the public parameterisation
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)
# Fr* has the generator 5; the 2^k-th roots of unity are its powers
FR_GENERATOR = 5


# -- fields: Fq ints, Fq2 = Fq[u]/(u^2 + 1) as pairs ------------------------
class _Fq:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)

    @staticmethod
    def is_zero(a):
        return a % Q == 0

    @staticmethod
    def norm(a):
        return a % Q


class _Fq2:
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def inv(a):
        d = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
        return (a[0] * d % Q, -a[1] * d % Q)

    @staticmethod
    def is_zero(a):
        return a[0] % Q == 0 and a[1] % Q == 0

    @staticmethod
    def norm(a):
        return (a[0] % Q, a[1] % Q)


# -- Jacobian group law (y^2 = x^3 + b; a = 0), any of the two fields --------
def _dbl(F, p):
    x, y, z = p
    if F.is_zero(z):
        return p
    a = F.mul(x, x)
    b = F.mul(y, y)
    c = F.mul(b, b)
    d = F.sub(F.mul(F.add(x, b), F.add(x, b)), F.add(a, c))
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    f = F.mul(e, e)
    x3 = F.sub(f, F.add(d, d))
    c8 = F.add(c, c)
    c8 = F.add(c8, c8)
    c8 = F.add(c8, c8)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    z3 = F.mul(y, z)
    return (x3, y3, F.add(z3, z3))


def _add(F, p, q):
    if F.is_zero(p[2]):
        return q
    if F.is_zero(q[2]):
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = F.mul(z1, z1), F.mul(z2, z2)
    u1, u2 = F.mul(x1, z2z2), F.mul(x2, z1z1)
    s1, s2 = F.mul(y1, F.mul(z2, z2z2)), F.mul(y2, F.mul(z1, z1z1))
    h, rr = F.sub(u2, u1), F.sub(s2, s1)
    if F.is_zero(h):
        return _dbl(F, p) if F.is_zero(rr) else (F.one, F.one, F.zero)
    hh = F.mul(h, h)
    hhh = F.mul(h, hh)
    v = F.mul(u1, hh)
    x3 = F.sub(F.sub(F.mul(rr, rr), hhh), F.add(v, v))
    y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.mul(s1, hhh))
    z3 = F.mul(F.mul(z1, z2), h)
    return (x3, y3, z3)


def _mul(F, base, e: int):
    """e * base, 4-bit fixed windows from the top."""
    e %= R
    table = [(F.one, F.one, F.zero), base]
    for _ in range(14):
        table.append(_add(F, table[-1], base))
    acc = (F.one, F.one, F.zero)
    for shift in range(((e.bit_length() + 3) // 4) * 4 - 4, -4, -4):
        for _ in range(4):
            acc = _dbl(F, acc)
        d = (e >> shift) & 15
        if d:
            acc = _add(F, acc, table[d])
    return acc


def _affine(F, p):
    """(x, y) of a Jacobian point, or None for the identity."""
    if F.is_zero(p[2]):
        return None
    zi = F.inv(p[2])
    zi2 = F.mul(zi, zi)
    return (F.mul(p[0], zi2), F.mul(p[1], F.mul(zi2, zi)))


def g1_mul(e: int):
    """(x, y) of e*G1, or None for the identity."""
    return _affine(_Fq, _mul(_Fq, (G1_GEN[0], G1_GEN[1], 1), e))


def g2_mul(e: int):
    """((x0, x1), (y0, y1)) of e*G2, or None for the identity."""
    return _affine(_Fq2, _mul(_Fq2, (G2_GEN[0], G2_GEN[1], _Fq2.one), e))


def g1_affine(p) -> object:
    """A Jacobian G1 triple of ints, as any program gives it, in affine form."""
    return _affine(_Fq, tuple(_Fq.norm(c) for c in p))


def g2_affine(p) -> object:
    """A Jacobian G2 triple of Fq2 pairs in affine form."""
    return _affine(_Fq2, tuple(_Fq2.norm(c) for c in p))


# -- scalars -----------------------------------------------------------------
def control_scalar(x: int, bits: int) -> int:
    """The control's scalar: ``x`` with bit ``bits - 1`` cleared, as a path
    one bit narrower than the stated width would hold it."""
    return x & ~(1 << (bits - 1))


def limb_dots(scalars, multipliers, clear_bit: int = -1) -> List[int]:
    """sum_i s_i*k_i, unreduced, for each scalar vector: ``scalars`` (B, L, n)
    int32 torch tensors, the low L of each vector's eight 32-bit limbs (the
    rest 0), ``multipliers`` (8, n) limbs on the same device.  Both sides
    are split into 16-bit halves and multiplied as float64 matrices: each
    product is below 2^32 and each sum of n <= 2^21 products below 2^53, so
    every partial sum is an integer that float64 holds exactly, in any
    order.  ``clear_bit`` >= 0 clears that bit of every scalar first."""
    import torch

    n = multipliers.shape[-1]
    assert n <= 1 << 21 and scalars.shape[-1] == n

    def halves(x, clear=-1):  # (..., L, n) 32-bit limbs -> (..., 2L, n) float64 16-bit halves
        u = x.to(torch.int64) & 0xFFFFFFFF
        if clear >= 0:
            u[..., clear // 32, :] &= ~(1 << (clear % 32))
        return torch.stack([u & 0xFFFF, u >> 16], dim=-2).flatten(-3, -2).to(torch.float64)

    m = halves(scalars, clear_bit) @ halves(multipliers).T  # (B, 2L, 16), exact integers
    m = m.to(torch.int64).cpu().tolist()
    return [sum(v << (16 * (a + b)) for a, row in enumerate(rows) for b, v in enumerate(row)) for rows in m]


def msm_expected(scalars, multipliers, bits: int = 0) -> list:
    """(x, y) of sum_i s_i*(k_i*G1) = (sum_i s_i*k_i)*G1 for each vector of
    ``scalars`` (as :func:`limb_dots`); with ``bits`` the control's answers
    (each scalar with bit ``bits - 1`` cleared)."""
    return [g1_mul(d % R) for d in limb_dots(scalars, multipliers, bits - 1 if bits else -1)]


# -- the multiplication chain and its Groth16 proof --------------------------
def mul_chain_witness(n: int, s1: int, s2: int) -> List[int]:
    """[1, out, s_1, ..., s_{n+1}] with s_{k+1} = s_k * s_{k-1} mod r and
    out = s_{n+1}: n constraints, n + 3 signals, one public."""
    chain = [s1 % R, s2 % R]
    for _ in range(n - 1):
        chain.append(chain[-1] * chain[-2] % R)
    return [1, chain[-1]] + chain


def mul_chain_rows(w: Sequence[int], n: int) -> Tuple[List[int], List[int], List[int]]:
    """Row values (a_j, b_j, c_j) = (<A_j,w>, <B_j,w>, <C_j,w>): rows
    0..n-2 are s_{k+1} * s_k = s_{k+2} (signals 3+k, 2+k, 4+k); row n-1 is
    out * 1 = s_{n+1} (signals 1, 0, n+2)."""
    a = list(w[3 : n + 2]) + [w[1]]
    b = list(w[2 : n + 1]) + [w[0]]
    c = list(w[4 : n + 3]) + [w[n + 2]]
    return a, b, c


def domain_size(n_constraints: int) -> int:
    return 1 << max(1, (n_constraints - 1).bit_length())


def lagrange_at(t: int, size: int) -> List[int]:
    """L_j(t) = w^j (t^N - 1) / (N (t - w^j)), j < N, over the N-th roots of
    unity w = 5^((r-1)/N)."""
    w = pow(FR_GENERATOR, (R - 1) // size, R)
    pw = [1] * size
    for j in range(1, size):
        pw[j] = pw[j - 1] * w % R
    den = [(t - x) % R for x in pw]
    prefix = [1] * (size + 1)
    for j in range(size):
        prefix[j + 1] = prefix[j] * den[j] % R
    inv = pow(prefix[size], -1, R)
    invs = [0] * size
    for j in range(size - 1, -1, -1):
        invs[j] = inv * prefix[j] % R
        inv = inv * den[j] % R
    scale = (pow(t, size, R) - 1) * pow(size, -1, R) % R
    return [pw[j] * scale % R * invs[j] % R for j in range(size)]


def _dot(xs: Sequence[int], ys: Sequence[int]) -> int:
    return sum(x * y for x, y in zip(xs, ys)) % R


class ChainProofs:
    """Expected proofs over one chain of ``n`` constraints and one key:
    ``toxic`` = (t, alpha, beta, gamma, delta).  :meth:`witness_terms` is
    the costly part (three dot products of length n), once per witness;
    :meth:`proof` is then a few products and three scalar multiplications."""

    def __init__(self, n: int, toxic: Sequence[int]):
        self.n = n
        self.t, self.alpha, self.beta, _, self.delta = (x % R for x in toxic)
        self.L = lagrange_at(self.t, domain_size(n))

    def witness_terms(self, w: Sequence[int], bits: int = 0) -> dict:
        """a(t), b(t), c(t) and the private part of beta*a + alpha*b + c;
        with ``bits``, the control's (private signals one bit narrower)."""
        if bits:
            w = list(w[:2]) + [control_scalar(x, bits) for x in w[2:]]
        n, L = self.n, self.L
        a, b, c = mul_chain_rows(w, n)
        at, bt, ct = _dot(a, L), _dot(b, L), _dot(c, L)
        # the public signals' columns: out (1) in A's last row, one (0) in B's
        pub = self.beta * (w[1] * L[n - 1]) + self.alpha * (w[0] * L[n - 1])
        priv = (self.beta * at + self.alpha * bt + ct - pub) % R
        return {"a": at, "b": bt, "c": ct, "priv": priv}

    def proof(self, terms: dict, r: int, s: int) -> tuple:
        """(A, B, C) in affine form for blinding (r, s)."""
        r, s = r % R, s % R
        A = (self.alpha + terms["a"] + r * self.delta) % R
        B = (self.beta + terms["b"] + s * self.delta) % R
        hz = (terms["a"] * terms["b"] - terms["c"]) % R
        Cs = ((terms["priv"] + hz) * pow(self.delta, -1, R) + s * A + r * B - r * s * self.delta) % R
        return g1_mul(A), g2_mul(B), g1_mul(Cs)
