"""The plain reference for a SHA-256 circuit: circomlib's templates as R1CS
rows and a witness, written bit by bit from their equations, and the
Groth16 proof over any R1CS in closed form.

Python integers and ``hashlib``, with BN254 from :mod:`benchmark.reference`;
nothing of ``jax``, the JAX package or the prover's packages, and nothing
that the program made.  The same file is ``tests/sha256_reference.py``.

* :class:`Sha256Circuit`: circomlib's ``Sha256(8 * message_bytes)``, each
  message byte range-checked by ``Num2Bits(8)``, the 256 digest bits public.
  Signals ``[one, digest bits (the first byte's top bit first), message
  bytes, intermediates in template order]``; a constant input gets no
  signal (a 1 is the constant one, signal 0; a 0 is left out), and a row
  whose A or B is then constant is multiplied out into C (a linear row,
  A = B = {}).  Gadgets, a bit at a time:
  ``Xor3``: b*c = mid, a*(1 - 2b - 2c + 4mid) = out - b - c + 2mid;
  ``Ch_t``: e*(f - g) = out - g;
  ``Maj_t``: b*c = mid, a*(b + c - 2mid) = out - mid;
  ``BinSum(32, k)`` and ``Num2Bits(8)``: o*(o - 1) = 0 for each output bit,
  then the linear row  sum_in 2^i*in_i - sum_out 2^j*o_j = 0.
  :meth:`Sha256Circuit.witness` computes every signal from its inputs'
  values and holds the public bits to ``hashlib.sha256``.
* :class:`Groth16Proofs`: with a(t) = sum_j <A_j, w> L_j(t) (b, c alike)
  over the 2^k-th roots of unity, and the public term
  sum_{i <= n_public} w_i (beta u_i(t) + alpha v_i(t) + w_i(t)) over the
  public columns u, v, w of A, B, C,

      A = alpha + a(t) + r*delta                                  (G1)
      B = beta + b(t) + s*delta                                   (G2)
      C = (beta*a(t) + alpha*b(t) + c(t) - public + a(t)b(t) - c(t)) / delta
          + s*A + r*B - r*s*delta                                 (G1)
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

from benchmark.reference import R, control_scalar, domain_size, g1_mul, g2_mul, lagrange_at

N_PUBLIC = 256
ONE = {0: 1}
ZERO: dict = {}


# -- the constants, from the primes ----------------------------------------
def _root(x: int, k: int) -> int:
    """floor(x ** (1/k)) by Newton's method from above."""
    if x < 2:
        return x
    y = 1 << (x.bit_length() // k + 1)
    while True:
        z = ((k - 1) * y + x // y ** (k - 1)) // k
        if z >= y:
            return y
        y = z


def _first_primes(n: int) -> List[int]:
    sieve = bytearray([1]) * 512
    sieve[0] = sieve[1] = 0
    for p in range(2, 23):
        if sieve[p]:
            sieve[p * p :: p] = bytearray(len(sieve[p * p :: p]))
    return [p for p in range(512) if sieve[p]][:n]


ROUND_K = [_root(p << 96, 3) % (1 << 32) for p in _first_primes(64)]
INITIAL_H = [_root(p << 64, 2) % (1 << 32) for p in _first_primes(8)]


def combo(*terms) -> dict:
    """sum of coefficient * linear combination, mod r, zeros dropped."""
    out: dict = {}
    for coef, lc in terms:
        for s, c in lc.items():
            out[s] = (out.get(s, 0) + coef * c) % R
    return {s: c for s, c in out.items() if c}


def _word(x: int) -> list:
    """A constant word: 32 constant bits, the least significant first."""
    return [ONE if (x >> k) & 1 else ZERO for k in range(32)]


class Sha256Circuit:
    """The rows (``A``, ``B``, ``C``) for messages of ``message_bytes``
    bytes; ``rounds`` below 64 keeps the first rounds of each compression
    only (tests; not SHA-256)."""

    def __init__(self, message_bytes: int, rounds: int = 64):
        self.message_bytes, self.rounds = message_bytes, rounds
        self.n_public = N_PUBLIC
        self.A: List[dict] = []
        self.B: List[dict] = []
        self.C: List[dict] = []
        self._vals: Optional[list] = None
        self._count = 0
        self._run()
        self.n_signals = self._count
        self.n_constraints = len(self.A)

    def witness(self, message: bytes) -> List[int]:
        """Every signal's value for ``message``; ValueError where the public
        bits are not ``hashlib.sha256(message)``."""
        if len(message) != self.message_bytes:
            raise ValueError("message length")
        self._vals = [1] + [0] * N_PUBLIC + list(message)
        try:
            self._run()
            w = self._vals
        finally:
            self._vals = None
        if len(w) != self.n_signals:
            raise ValueError(f"{len(w)} values for {self.n_signals} signals")
        if self.rounds == 64 and digest(w) != hashlib.sha256(bytes(message)).digest():
            raise ValueError("the witness's public bits are not hashlib's digest")
        return w

    # -- signals and rows ----------------------------------------------------
    def _val(self, lc: dict) -> int:
        return sum(c * self._vals[s] for s, c in lc.items()) % R

    def _signals(self, values: Sequence) -> list:
        """New signals, in order; their values where a witness is made."""
        first = self._count
        self._count += len(values)
        if self._vals is not None:
            self._vals.extend(values)
        return [{s: 1} for s in range(first, self._count)]

    def _constraint(self, a: dict, b: dict, c: dict) -> None:
        if self._vals is not None:
            return
        for x, y in ((a, b), (b, a)):
            if set(x) <= {0}:  # a constant factor: a linear row
                self.A.append({})
                self.B.append({})
                self.C.append(combo((1, c), (-x.get(0, 0), y)))
                return
        self.A.append(a)
        self.B.append(b)
        self.C.append(c)

    def _bits_of(self, x: dict, n: int) -> list:
        return [(self._val(x) >> k) & 1 for k in range(n)] if self._vals is not None else [None] * n

    # -- templates -------------------------------------------------------------
    def _num2bits8(self, i: int) -> list:
        x = {1 + N_PUBLIC + i: 1}
        out = self._signals(self._bits_of(x, 8))
        for o in out:
            self._constraint(o, combo((1, o), (-1, ONE)), ZERO)
        self._constraint(ZERO, ZERO, combo(*((1 << k, o) for k, o in enumerate(out)), (-1, x)))
        return out

    def _xor3(self, a, b, c) -> list:
        if self._vals is not None:
            va, vb, vc = ([self._val(x) for x in y] for y in (a, b, c))
            mid = self._signals([x * y for x, y in zip(vb, vc)])
            out = self._signals([x ^ y ^ z for x, y, z in zip(va, vb, vc)])
            return out
        mid, out = self._signals([None] * 32), self._signals([None] * 32)
        for k in range(32):
            self._constraint(b[k], c[k], mid[k])
            self._constraint(a[k], combo((1, ONE), (-2, b[k]), (-2, c[k]), (4, mid[k])),
                             combo((1, out[k]), (-1, b[k]), (-1, c[k]), (2, mid[k])))
        return out

    def _ch(self, e, f, g) -> list:
        if self._vals is not None:
            return self._signals([self._val(f[k]) if self._val(e[k]) else self._val(g[k]) for k in range(32)])
        out = self._signals([None] * 32)
        for k in range(32):
            self._constraint(e[k], combo((1, f[k]), (-1, g[k])), combo((1, out[k]), (-1, g[k])))
        return out

    def _maj(self, a, b, c) -> list:
        if self._vals is not None:
            va, vb, vc = ([self._val(x) for x in y] for y in (a, b, c))
            mid = self._signals([x * y for x, y in zip(vb, vc)])
            return self._signals([1 if x + y + z >= 2 else 0 for x, y, z in zip(va, vb, vc)])
        mid, out = self._signals([None] * 32), self._signals([None] * 32)
        for k in range(32):
            self._constraint(b[k], c[k], mid[k])
            self._constraint(a[k], combo((1, b[k]), (1, c[k]), (-2, mid[k])), combo((1, out[k]), (-1, mid[k])))
        return out

    def _binsum(self, ops, digest_word: Optional[int] = None) -> list:
        nout = ((2**32 - 1) * len(ops)).bit_length()
        total = combo(*((1 << i, x) for op in ops for i, x in enumerate(op)))
        bits = self._bits_of(total, nout)
        if digest_word is None:
            out = self._signals(bits)
        else:
            low = [1 + 32 * digest_word + 31 - k for k in range(32)]
            if self._vals is not None:
                for s, v in zip(low, bits):
                    self._vals[s] = v
            out = [{s: 1} for s in low] + self._signals(bits[32:])
        for o in out:
            self._constraint(o, combo((1, o), (-1, ONE)), ZERO)
        self._constraint(ZERO, ZERO, combo((1, total), *((-(1 << k), o) for k, o in enumerate(out))))
        return out[:32]

    def _run(self) -> None:
        self._count = 1 + N_PUBLIC + self.message_bytes
        n_bits = 8 * self.message_bytes
        blocks = (n_bits + 64) // 512 + 1
        # circom's paddedIn: the message bits (each byte's top bit first), a
        # 1, zeros, and the bit length in 64 bits, the top bit first
        stream = []
        for i in range(self.message_bytes):
            bits = self._num2bits8(i)
            stream += bits[::-1]
        stream.append(ONE)
        stream += [ZERO] * (512 * blocks - 64 - len(stream))
        stream += [ONE if (n_bits >> (63 - k)) & 1 else ZERO for k in range(64)]
        hin = [_word(h) for h in INITIAL_H]
        for blk in range(blocks):
            inp = stream[512 * blk : 512 * (blk + 1)]
            w = [[inp[t * 32 + 31 - k] for k in range(32)] for t in range(16)]
            rotr = lambda x, n: [x[(k + n) % 32] for k in range(32)]
            shr = lambda x, n: [x[k + n] if k + n < 32 else ZERO for k in range(32)]
            for t in range(16, self.rounds):
                sigma1 = self._xor3(rotr(w[t - 2], 17), rotr(w[t - 2], 19), shr(w[t - 2], 10))
                sigma0 = self._xor3(rotr(w[t - 15], 7), rotr(w[t - 15], 18), shr(w[t - 15], 3))
                w.append(self._binsum([sigma1, w[t - 7], sigma0, w[t - 16]]))
            a, b, c, d, e, f, g, h = hin
            for t in range(self.rounds):
                ch = self._ch(e, f, g)
                s1 = self._xor3(rotr(e, 6), rotr(e, 11), rotr(e, 25))
                t1 = self._binsum([h, s1, ch, _word(ROUND_K[t]), w[t]])
                s0 = self._xor3(rotr(a, 2), rotr(a, 13), rotr(a, 22))
                maj = self._maj(a, b, c)
                t2 = self._binsum([s0, maj])
                a_next = self._binsum([t1, t2])
                e_next = self._binsum([d, t1])
                h, g, f, e, d, c, b, a = g, f, e, e_next, c, b, a, a_next
            final = blk == blocks - 1
            hin = [self._binsum([hin[j], x], j if final else None) for j, x in enumerate((a, b, c, d, e, f, g, h))]


def digest(w: Sequence[int]) -> bytes:
    """The 32 bytes that a witness's public bits spell."""
    return bytes(sum(w[1 + 8 * i + k] << (7 - k) for k in range(8)) for i in range(32))


# -- the Groth16 proof in closed form ----------------------------------------
class Groth16Proofs:
    """Expected proofs over one R1CS (rows ``A``, ``B``, ``C``, signals
    0..``n_public`` public) and one key: ``toxic`` = (t, alpha, beta, gamma,
    delta).  :meth:`witness_terms` once per witness (three sparse products
    and their sums at t), then :meth:`proof` per blinding pair."""

    def __init__(self, A, B, C, n_public: int, toxic: Sequence[int]):
        self.A, self.B, self.C = A, B, C
        self.lo = n_public + 1
        self.t, self.alpha, self.beta, _, self.delta = (x % R for x in toxic)
        self.L = lagrange_at(self.t, domain_size(len(A)))
        cols = []
        for rows in (A, B, C):
            col = [0] * self.lo
            for j, row in enumerate(rows):
                for s, c in row.items():
                    if s < self.lo:
                        col[s] += c * self.L[j]
            cols.append(col)
        self.public_coef = [(self.beta * u + self.alpha * v + x) % R for u, v, x in zip(*cols)]

    def _at_t(self, rows, w) -> int:
        L, total = self.L, 0
        for j, row in enumerate(rows):
            if row:
                v = sum(c * w[s] for s, c in row.items()) % R
                if v:
                    total += v * L[j]
        return total % R

    def witness_terms(self, w: Sequence[int], bits: int = 0) -> dict:
        """a(t), b(t), c(t) and beta*a + alpha*b + c less its public part;
        with ``bits``, the control's (private signals one bit narrower)."""
        if bits:
            w = list(w[: self.lo]) + [control_scalar(x, bits) for x in w[self.lo :]]
        at, bt, ct = (self._at_t(rows, w) for rows in (self.A, self.B, self.C))
        public = sum(x * c for x, c in zip(w, self.public_coef))
        priv = (self.beta * at + self.alpha * bt + ct - public) % R
        return {"a": at, "b": bt, "c": ct, "priv": priv}

    def proof(self, terms: dict, r: int, s: int) -> tuple:
        """(A, B, C) in affine form for blinding (r, s)."""
        r, s = r % R, s % R
        A = (self.alpha + terms["a"] + r * self.delta) % R
        B = (self.beta + terms["b"] + s * self.delta) % R
        hz = (terms["a"] * terms["b"] - terms["c"]) % R
        Cs = ((terms["priv"] + hz) * pow(self.delta, -1, R) + s * A + r * B - r * s * self.delta) % R
        return g1_mul(A), g2_mul(B), g1_mul(Cs)
