"""circomlib's SHA-256 as a :class:`..synthetic.SparseR1CS`, and its witness.

    r1cs = sha256_r1cs(len(message))        # the rows depend on the length alone
    r1cs.witness = witness(r1cs, message)    # one witness a message

The circuit is circomlib's ``Sha256(nBits)`` (``circuits/sha256/``:
``sha256compression.circom`` over ``Xor3``, ``Ch_t``, ``Maj_t``,
``SigmaPlus``, ``T1``, ``T2`` and ``BinSum``) over ``8 * len(message)`` bits,
each message byte a private signal range-checked by ``Num2Bits(8)``, and the
256 digest bits public.

Signals: ``[one, digest bits 0..255, message bytes, intermediates]``.  Digest
bit i is bit 7 - i % 8 of digest byte i // 8 (the most significant bit
first).  The intermediates come in template order: each byte's
``Num2Bits(8)`` outputs (least significant bit first), then for each
512-bit block its compression: the message schedule's words 16 .. rounds - 1
(``SigmaPlus``: sigma1's ``Xor3``, sigma0's ``Xor3``, ``BinSum(32, 4)``), then
each round (``T1``: ``Ch_t``, Sigma1's ``Xor3``, ``BinSum(32, 5)``; ``T2``:
Sigma0's ``Xor3``, ``Maj_t``, ``BinSum(32, 2)``; then the sums that make the
new ``a`` and the new ``e``), then the eight final sums.  Within a template a
signal array comes whole, bit 0 first: ``Xor3`` and ``Maj_t`` their ``mid``
array, then ``out``; ``BinSum(32, k)`` its ``nbits((2^32 - 1) * k)`` output
bits, of which only the low 32 go on.  In the last block's final sums those
low 32 bits are the digest signals themselves, and only the carries are new.

Rows, in the same order, each ``A * B = C`` over sparse {signal: coefficient}
rows (coefficients mod r, none zero):

* ``Xor3(a, b, c)``, a bit at a time: ``b * c = mid``, then
  ``a * (1 - 2b - 2c + 4mid) = out - b - c + 2mid``;
* ``Ch_t(e, f, g)``: ``e * (f - g) = out - g``;
* ``Maj_t(a, b, c)``: ``b * c = mid``, then ``a * (b + c - 2mid) = out - mid``;
* ``BinSum`` and ``Num2Bits``: each output bit ``o * (o - 1) = 0``, then one
  linear row with A = B = {} and C = (the inputs' weighted sum) - (the
  outputs' weighted sum).

Rotations and shifts re-index bits.  A constant input (a bit that a shift
brings in, K_t, the initial hash value, the padding) gets no signal: a
constant bit 1 is signal 0 (the constant one), a constant bit 0 contributes
nothing.  A row whose A or B is then a constant (on signal 0 alone, or
empty) is multiplied out into C: a linear row, A = B = {}.  Linear rows stay
rows, as circom ``--O0`` emits them.

``rounds`` below 64 cuts every compression to its first ``rounds`` rounds
(and the schedule to the words they use) for small tests: that is not
SHA-256.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from ..bn128.constants import R
from ..profiling import span
from ..synthetic import SparseR1CS

__all__ = ["K", "H0", "Sha256Layout", "Sha256R1CS", "sha256_r1cs", "witness", "digest"]

N_PUBLIC = 256
M32 = (1 << 32) - 1


def _primes(n: int) -> List[int]:
    out: List[int] = []
    k = 2
    while len(out) < n:
        if all(k % p for p in out if p * p <= k):
            out.append(k)
        k += 1
    return out


def _icbrt(x: int) -> int:
    """floor(x ** (1/3)) for an int x >= 0, by bisection."""
    lo, hi = 0, 1 << (x.bit_length() // 3 + 1)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid * mid * mid <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


# FIPS 180-4 4.2.2 and 5.3.3: the first 32 bits of the fractional parts of
# the cube roots of the first 64 primes, and of the square roots of the first 8
K = tuple(_icbrt(p << 96) & M32 for p in _primes(64))
H0 = tuple(math.isqrt(p << 64) & M32 for p in _primes(8))


def _nout(ops: int) -> int:
    """BinSum(32, ops)'s output bits: nbits((2^32 - 1) * ops)."""
    return (M32 * ops).bit_length()


@dataclass(frozen=True)
class Sha256Layout:
    """What the witness needs of a circuit: its message length and rounds,
    and the counts it must come to."""

    message_bytes: int
    rounds: int
    n_signals: int
    n_constraints: int


@dataclass
class Sha256R1CS(SparseR1CS):
    """A :class:`..synthetic.SparseR1CS` that knows its layout."""

    layout: Sha256Layout = None


def _walk(be, n_bytes: int, rounds: int):
    """The templates in order on the backend ``be`` (:class:`_Rows` writes
    the rows, :class:`_Values` the witness); words are 32 bits, bit 0 the
    least significant."""
    blocks = (8 * n_bytes + 64) // 512 + 1
    tail = [0x80] + [0] * (64 * blocks - n_bytes - 9) + list((8 * n_bytes).to_bytes(8, "big"))
    data = [be.byte(i) for i in range(n_bytes)] + [be.const_byte(v) for v in tail]
    hin = [be.const(h) for h in H0]
    for blk in range(blocks):
        base = 64 * blk
        w = [be.word(data[base + 4 * t : base + 4 * t + 4]) for t in range(16)]
        for t in range(16, rounds):
            s1 = be.xor3(be.rotr(w[t - 2], 17), be.rotr(w[t - 2], 19), be.shr(w[t - 2], 10))
            s0 = be.xor3(be.rotr(w[t - 15], 7), be.rotr(w[t - 15], 18), be.shr(w[t - 15], 3))
            w.append(be.binsum([s1, w[t - 7], s0, w[t - 16]]))
        a, b, c, d, e, f, g, h = hin
        for t in range(rounds):
            ch = be.ch(e, f, g)
            big1 = be.xor3(be.rotr(e, 6), be.rotr(e, 11), be.rotr(e, 25))
            t1 = be.binsum([h, big1, ch, be.const(K[t]), w[t]])
            big0 = be.xor3(be.rotr(a, 2), be.rotr(a, 13), be.rotr(a, 22))
            mj = be.maj(a, b, c)
            t2 = be.binsum([big0, mj])
            new_a = be.binsum([t1, t2])
            new_e = be.binsum([d, t1])
            a, b, c, d, e, f, g, h = new_a, a, b, c, new_e, e, f, g
        last = blk == blocks - 1
        hin = [be.binsum([hin[j], st], digest_word=j if last else None)
               for j, st in enumerate((a, b, c, d, e, f, g, h))]


def _digest_signal(word: int, k: int) -> int:
    """The signal of bit k (bit 0 the least significant) of digest word j."""
    return 1 + 32 * word + 31 - k


class _Rows:
    """Writes the rows; a word is a list of 32 wires, a wire a signal index
    or None for the constant 0 (the constant 1 is signal 0)."""

    def __init__(self, n_bytes: int):
        self.n = 1 + N_PUBLIC + n_bytes
        self.A: List[dict] = []
        self.B: List[dict] = []
        self.C: List[dict] = []

    def _new(self, k: int) -> List[int]:
        self.n += k
        return list(range(self.n - k, self.n))

    @staticmethod
    def _lc(*terms) -> dict:
        """{signal: coefficient mod r} of (wire, coefficient) terms, the
        None wires left out, equal signals added, zeros dropped."""
        d: dict = {}
        for s, v in terms:
            if s is not None:
                d[s] = d.get(s, 0) + v
        return {s: v % R for s, v in d.items() if v % R}

    def _row(self, a: dict, b: dict, c: dict) -> None:
        const_a, const_b = a.keys() <= {0}, b.keys() <= {0}
        if const_a or const_b:
            k, other = (a.get(0, 0), b) if const_a else (b.get(0, 0), a)
            c = self._lc(*c.items(), *((s, -k * v) for s, v in other.items()))
            a, b = {}, {}
        self.A.append(a)
        self.B.append(b)
        self.C.append(c)

    def _bits(self, outs: List[int]) -> None:
        for o in outs:
            self._row({o: 1}, {o: 1, 0: R - 1}, {})

    def byte(self, i: int) -> List[int]:
        outs = self._new(8)
        self._bits(outs)
        self._row({}, {}, self._lc(*((o, 1 << k) for k, o in enumerate(outs)), (1 + N_PUBLIC + i, -1)))
        return outs

    @staticmethod
    def const_byte(v: int) -> List:
        return [0 if (v >> k) & 1 else None for k in range(8)]

    @staticmethod
    def const(x: int) -> List:
        return [0 if (x >> k) & 1 else None for k in range(32)]

    @staticmethod
    def word(four) -> List:
        """Four bytes, the most significant first, as one word."""
        return four[3] + four[2] + four[1] + four[0]

    @staticmethod
    def rotr(x: List, r: int) -> List:
        return [x[(i + r) % 32] for i in range(32)]

    @staticmethod
    def shr(x: List, r: int) -> List:
        return [x[i + r] if i + r < 32 else None for i in range(32)]

    def xor3(self, a, b, c) -> List[int]:
        mids, outs = self._new(32), self._new(32)
        lc = self._lc
        for k in range(32):
            ak, bk, ck, m, o = a[k], b[k], c[k], mids[k], outs[k]
            self._row(lc((bk, 1)), lc((ck, 1)), {m: 1})
            self._row(lc((ak, 1)), lc((0, 1), (bk, -2), (ck, -2), (m, 4)), lc((o, 1), (bk, -1), (ck, -1), (m, 2)))
        return outs

    def ch(self, e, f, g) -> List[int]:
        outs = self._new(32)
        lc = self._lc
        for k in range(32):
            self._row(lc((e[k], 1)), lc((f[k], 1), (g[k], -1)), lc((outs[k], 1), (g[k], -1)))
        return outs

    def maj(self, a, b, c) -> List[int]:
        mids, outs = self._new(32), self._new(32)
        lc = self._lc
        for k in range(32):
            bk, ck, m = b[k], c[k], mids[k]
            self._row(lc((bk, 1)), lc((ck, 1)), {m: 1})
            self._row(lc((a[k], 1)), lc((bk, 1), (ck, 1), (m, -2)), lc((outs[k], 1), (m, -1)))
        return outs

    def binsum(self, ops, digest_word=None) -> List[int]:
        nout = _nout(len(ops))
        if digest_word is None:
            outs = self._new(nout)
        else:
            outs = [_digest_signal(digest_word, k) for k in range(32)] + self._new(nout - 32)
        self._bits(outs)
        terms = [(x, 1 << i) for op in ops for i, x in enumerate(op)]
        terms += [(o, -(1 << k)) for k, o in enumerate(outs)]
        self._row({}, {}, self._lc(*terms))
        return outs[:32]


class _Values:
    """Computes the witness; a word is an int below 2^32, a byte an int
    below 2^8."""

    def __init__(self, message: bytes):
        self.w = [1] + [0] * N_PUBLIC + list(message)

    def _bits(self, x: int, n: int) -> None:
        self.w.extend((x >> i) & 1 for i in range(n))

    def byte(self, i: int) -> int:
        v = self.w[1 + N_PUBLIC + i]
        self._bits(v, 8)
        return v

    @staticmethod
    def const_byte(v: int) -> int:
        return v

    @staticmethod
    def const(x: int) -> int:
        return x

    @staticmethod
    def word(four) -> int:
        return (four[0] << 24) | (four[1] << 16) | (four[2] << 8) | four[3]

    @staticmethod
    def rotr(x: int, r: int) -> int:
        return ((x >> r) | (x << (32 - r))) & M32

    @staticmethod
    def shr(x: int, r: int) -> int:
        return x >> r

    def xor3(self, a: int, b: int, c: int) -> int:
        self._bits(b & c, 32)
        out = a ^ b ^ c
        self._bits(out, 32)
        return out

    def ch(self, e: int, f: int, g: int) -> int:
        out = (e & f) ^ (~e & g & M32)
        self._bits(out, 32)
        return out

    def maj(self, a: int, b: int, c: int) -> int:
        self._bits(b & c, 32)
        out = (a & b) ^ (a & c) ^ (b & c)
        self._bits(out, 32)
        return out

    def binsum(self, ops, digest_word=None) -> int:
        total, nout = sum(ops), _nout(len(ops))
        if digest_word is None:
            self._bits(total, nout)
        else:
            for k in range(32):
                self.w[_digest_signal(digest_word, k)] = (total >> k) & 1
            self._bits(total >> 32, nout - 32)
        return total & M32


def sha256_r1cs(message_bytes: int, rounds: int = 64) -> Sha256R1CS:
    """The circuit over messages of ``message_bytes`` bytes (module
    docstring), without a witness; the ``circuit.sha256.r1cs`` span."""
    if not 0 < rounds <= 64 or message_bytes < 0:
        raise ValueError(f"rounds {rounds} (1..64), message_bytes {message_bytes} (>= 0)")
    with span("circuit.sha256.r1cs"):
        be = _Rows(message_bytes)
        _walk(be, message_bytes, rounds)
        layout = Sha256Layout(message_bytes, rounds, be.n, len(be.A))
        return Sha256R1CS(n_constraints=len(be.A), n_signals=be.n, n_public=N_PUBLIC,
                          A=be.A, B=be.B, C=be.C, layout=layout)


def witness(r1cs_or_layout, message: bytes) -> List[int]:
    """The witness of ``message`` for a circuit of :func:`sha256_r1cs` (or
    its :class:`Sha256Layout`): every signal's value, the digest bits in
    signals 1..256; the ``circuit.sha256.witness`` span."""
    layout = getattr(r1cs_or_layout, "layout", r1cs_or_layout)
    message = bytes(message)
    if len(message) != layout.message_bytes:
        raise ValueError(f"a {len(message)}-byte message for a {layout.message_bytes}-byte circuit")
    with span("circuit.sha256.witness"):
        be = _Values(message)
        _walk(be, layout.message_bytes, layout.rounds)
    if len(be.w) != layout.n_signals:
        raise AssertionError(f"{len(be.w)} values for {layout.n_signals} signals")
    return be.w


def digest(w: List[int]) -> bytes:
    """The digest that a witness's public signals hold."""
    return bytes(int("".join(str(b) for b in w[1 + 8 * i : 9 + 8 * i]), 2) for i in range(32))
