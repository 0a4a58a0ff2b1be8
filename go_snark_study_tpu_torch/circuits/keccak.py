"""Keccak-256 (Ethereum's hash) as a :class:`..synthetic.SparseR1CS`, and its
witness.

    r1cs = keccak_r1cs(len(message))        # the rows depend on the length alone
    r1cs.witness = witness(r1cs, message)    # one witness a message

Keccak-256 is Keccak-f[1600] with a rate of 136 bytes (1,088 bits) and the
original Keccak padding: the byte 0x01 after the message, 0x80 in the last
byte of the block (0x81 where the two meet).  FIPS 202's SHA3-256 is the same
sponge with 0x06 in place of 0x01.  The gates
follow circomlib's ``XOR`` as the public circuit of vocdoni/keccak256-circom
builds Keccak from XOR and AND gates; each message byte is a private signal
range-checked by ``Num2Bits(8)``, and the 256 digest bits are public.

The state is 5 x 5 lanes of 64 bits, lane (x, y) at index x + 5y; bit z of a
lane is bit z of the little-endian 8 bytes at offset 8(x + 5y) of a block.
Signals: ``[one, digest bits 0..255, message bytes, intermediates]``.
Digest bit i is bit 7 - i % 8 of digest byte i // 8 (the most significant
bit first), digest byte k being byte k of the final state.  The
intermediates come in gadget order: each byte's ``Num2Bits(8)`` outputs (the
least significant bit first), then for each block its absorption (block 1
is the state itself and costs nothing; a later block XORs each of its 1,088
bits into the state, lane by lane) and the permutation's rounds: theta
(C[x] as ((((A[x,0] ^ A[x,1]) ^ A[x,2]) ^ A[x,3]) ^ A[x,4]) for x = 0..4;
D[x] = C[x-1] ^ rot(C[x+1], 1) for x = 0..4; A[i] ^= D[i % 5] for i =
0..24), rho and pi (re-indexing only), chi (for each lane i in order,
its 64 ``t = (1 - b) * c`` then its 64 ``out = a ^ t``), iota.  A gadget's
outputs over a lane come bit 0 first.  In the last round of the last block
the outputs that are the final state's first 256 bits are the digest
signals themselves.

Rows, in the same order, each ``A * B = C`` over sparse {signal:
coefficient} rows (coefficients mod r, none zero):

* ``XOR(a, b)``: ``(2a) * b = a + b - out`` (circomlib's ``XOR``);
* chi's AND-NOT: ``(1 - b) * c = t``;
* ``Num2Bits(8)``: each output bit ``o * (o - 1) = 0``, then one linear row
  with A = B = {} and C = (the bits' weighted sum) - (the byte);
* iota, and a padding bit absorbed: where the constant bit is 1, a linear
  row ``out = 1 - a``; a 0 bit costs nothing.

A constant input (the padding, the zero capacity of the first block) gets no
signal: a constant bit 1 is signal 0 (the constant one), a constant bit 0
contributes nothing.  A row whose A or B is then a constant (on signal 0
alone, or empty) is multiplied out into C: a linear row, A = B = {}.  Linear
rows stay rows, as circom ``--O0`` emits them.

``rounds`` below 24 keeps each permutation's first ``rounds`` rounds for
small tests: that is not Keccak.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..bn128.constants import R
from ..profiling import span
from ..synthetic import SparseR1CS

__all__ = ["RC", "RHO", "RATE_BYTES", "KeccakLayout", "KeccakR1CS", "keccak_r1cs", "witness", "digest"]

N_PUBLIC = 256
RATE_BYTES = 136
RATE_LANES = RATE_BYTES // 8
M64 = (1 << 64) - 1
NEG1 = R - 1


def _rc_bit(t: int) -> int:
    """FIPS 202 algorithm 5, rc(t): the output of the LFSR x^8 + x^6 + x^5
    + x^4 + 1 after t mod 255 steps, bit k of ``reg`` its R[k]."""
    reg = 1
    for _ in range(t % 255):
        reg <<= 1
        if reg & 0x100:
            reg ^= 0x171
    return reg & 1


def _rho_offsets() -> tuple:
    """FIPS 202 algorithm 2's offsets, by lane index x + 5y."""
    out = [0] * 25
    x, y = 1, 0
    for t in range(24):
        out[x + 5 * y] = (t + 1) * (t + 2) // 2 % 64
        x, y = y, (2 * x + 3 * y) % 5
    return tuple(out)


# FIPS 202 3.2.5: RC[ir] has bit 2^j - 1 = rc(j + 7 ir), j = 0..6
RC = tuple(sum(_rc_bit(j + 7 * ir) << ((1 << j) - 1) for j in range(7)) for ir in range(24))
RHO = _rho_offsets()


@dataclass(frozen=True)
class KeccakLayout:
    """What the witness needs of a circuit: its message length and rounds,
    and the counts it must come to."""

    message_bytes: int
    rounds: int
    n_signals: int
    n_constraints: int


@dataclass
class KeccakR1CS(SparseR1CS):
    """A :class:`..synthetic.SparseR1CS` that knows its layout."""

    layout: KeccakLayout = None


def _digest_targets(lane: int) -> List[int]:
    """The digest signals of bits 0..63 of lane ``lane`` (0..3, y = 0)."""
    return [1 + 8 * (8 * lane + z // 8) + 7 - z % 8 for z in range(64)]


def _walk(be, n_bytes: int, rounds: int):
    """The gadgets in order on the backend ``be`` (:class:`_Rows` writes the
    rows, :class:`_Values` the witness); a lane's bit 0 is its least
    significant."""
    blocks = n_bytes // RATE_BYTES + 1
    pad = bytearray(RATE_BYTES * blocks - n_bytes)
    pad[0] |= 0x01
    pad[-1] |= 0x80
    data = [be.byte(i) for i in range(n_bytes)] + [be.const_byte(v) for v in pad]

    def changed(j0: int) -> int:
        """The bits of the lane of bytes j0.. that absorbing gives a signal:
        the message's, and the padding's 1 bits."""
        return sum((0xFF if j < n_bytes else pad[j - n_bytes]) << (8 * k) for k, j in enumerate(range(j0, j0 + 8)))

    state = None
    for blk in range(blocks):
        base = RATE_BYTES * blk
        block = [be.lane(data[base + 8 * i : base + 8 * i + 8]) for i in range(RATE_LANES)]
        if state is None:
            state = block + [be.const_lane()] * (25 - RATE_LANES)
        else:
            state[:RATE_LANES] = [be.absorb(state[i], block[i], changed(base + 8 * i)) for i in range(RATE_LANES)]
        last_block = blk == blocks - 1
        for ir in range(rounds):
            c = []
            for x in range(5):
                acc = be.xor(state[x], state[x + 5])
                for y in range(2, 5):
                    acc = be.xor(acc, state[x + 5 * y])
                c.append(acc)
            d = [be.xor(c[(x - 1) % 5], be.rot(c[(x + 1) % 5], 1)) for x in range(5)]
            state = [be.xor(state[i], d[i % 5]) for i in range(25)]
            b = [None] * 25
            for x in range(5):
                for y in range(5):
                    b[y + 5 * ((2 * x + 3 * y) % 5)] = be.rot(state[x + 5 * y], RHO[x + 5 * y])
            final = last_block and ir == rounds - 1
            rc = RC[ir]
            for i in range(25):
                row = i - i % 5
                t = be.andn(b[row + (i % 5 + 1) % 5], b[row + (i % 5 + 2) % 5])
                targets = None
                if final and i < 4:
                    targets = _digest_targets(i)
                    if i == 0:  # iota writes the bits its constant sets
                        targets = [None if (rc >> z) & 1 else s for z, s in enumerate(targets)]
                state[i] = be.xor(b[i], t, targets)
            state[0] = be.iota(state[0], rc, _digest_targets(0) if final else None)


class _Rows:
    """Writes the rows; a lane is a list of 64 wires, a wire a signal index
    or None for the constant 0 (the constant 1 is signal 0)."""

    def __init__(self, n_bytes: int):
        self.n = 1 + N_PUBLIC + n_bytes
        self.A: List[dict] = []
        self.B: List[dict] = []
        self.C: List[dict] = []

    def _new(self, k: int) -> List[int]:
        self.n += k
        return list(range(self.n - k, self.n))

    def _outs(self, targets) -> List[int]:
        """64 output signals: the given ones, new ones where None."""
        if targets is None:
            return self._new(64)
        return [s if s is not None else self._new(1)[0] for s in targets]

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

    def _xor_row(self, a, b, o: int) -> None:
        if a and b and a != b:  # two signals: nothing to fold
            self.A.append({a: 2})
            self.B.append({b: 1})
            self.C.append({a: 1, b: 1, o: NEG1})
        else:
            self._row(self._lc((a, 2)), self._lc((b, 1)), self._lc((a, 1), (b, 1), (o, -1)))

    def byte(self, i: int) -> List[int]:
        outs = self._new(8)
        for o in outs:
            self._row({o: 1}, {o: 1, 0: NEG1}, {})
        self._row({}, {}, self._lc(*((o, 1 << k) for k, o in enumerate(outs)), (1 + N_PUBLIC + i, -1)))
        return outs

    @staticmethod
    def const_byte(v: int) -> List:
        return [0 if (v >> k) & 1 else None for k in range(8)]

    @staticmethod
    def lane(eight) -> List:
        """Eight bytes, the least significant first, as one lane."""
        return [w for byte in eight for w in byte]

    @staticmethod
    def const_lane() -> List:
        return [None] * 64

    @staticmethod
    def rot(x: List, r: int) -> List:
        return [x[(z - r) % 64] for z in range(64)]

    def xor(self, a, b, targets=None) -> List[int]:
        outs = self._outs(targets)
        for z in range(64):
            self._xor_row(a[z], b[z], outs[z])
        return outs

    def andn(self, b, c) -> List[int]:
        outs = self._new(64)
        for z in range(64):
            bz, cz, t = b[z], c[z], outs[z]
            if bz and cz:
                self.A.append({0: 1, bz: NEG1})
                self.B.append({cz: 1})
                self.C.append({t: 1})
            else:
                self._row(self._lc((0, 1), (bz, -1)), self._lc((cz, 1)), {t: 1})
        return outs

    def absorb(self, s, m, changed: int) -> List:
        out = list(s)
        for z in range(64):
            if (changed >> z) & 1:
                out[z] = self._new(1)[0]
                self._xor_row(s[z], m[z], out[z])
        return out

    def iota(self, s, rc: int, targets=None) -> List:
        out = list(s)
        for z in range(64):
            if (rc >> z) & 1:
                out[z] = targets[z] if targets is not None else self._new(1)[0]
                self._xor_row(s[z], 0, out[z])
        return out


class _Values:
    """Computes the witness; a lane is an int below 2^64, a byte an int
    below 2^8."""

    def __init__(self, message: bytes):
        self.w = [1] + [0] * N_PUBLIC + list(message)

    def _bits(self, x: int, n: int) -> None:
        self.w.extend((x >> i) & 1 for i in range(n))

    def _put(self, x: int, targets) -> None:
        if targets is None:
            self._bits(x, 64)
            return
        for z, s in enumerate(targets):
            if s is None:
                self.w.append((x >> z) & 1)
            else:
                self.w[s] = (x >> z) & 1

    def byte(self, i: int) -> int:
        v = self.w[1 + N_PUBLIC + i]
        self._bits(v, 8)
        return v

    @staticmethod
    def const_byte(v: int) -> int:
        return v

    @staticmethod
    def lane(eight) -> int:
        return int.from_bytes(bytes(eight), "little")

    @staticmethod
    def const_lane() -> int:
        return 0

    @staticmethod
    def rot(x: int, r: int) -> int:
        return ((x << r) | (x >> (64 - r))) & M64 if r else x

    def xor(self, a: int, b: int, targets=None) -> int:
        out = a ^ b
        self._put(out, targets)
        return out

    def andn(self, b: int, c: int) -> int:
        out = ~b & c & M64
        self._bits(out, 64)
        return out

    def absorb(self, s: int, m: int, changed: int) -> int:
        out = s ^ m
        self.w.extend((out >> z) & 1 for z in range(64) if (changed >> z) & 1)
        return out

    def iota(self, s: int, rc: int, targets=None) -> int:
        out = s ^ rc
        for z in range(64):
            if (rc >> z) & 1:
                if targets is None:
                    self.w.append((out >> z) & 1)
                else:
                    self.w[targets[z]] = (out >> z) & 1
        return out


def keccak_r1cs(message_bytes: int, rounds: int = 24) -> KeccakR1CS:
    """The circuit over messages of ``message_bytes`` bytes (module
    docstring), without a witness; the ``circuit.keccak.r1cs`` span."""
    if not 0 < rounds <= 24 or message_bytes < 0:
        raise ValueError(f"rounds {rounds} (1..24), message_bytes {message_bytes} (>= 0)")
    with span("circuit.keccak.r1cs"):
        be = _Rows(message_bytes)
        _walk(be, message_bytes, rounds)
        layout = KeccakLayout(message_bytes, rounds, be.n, len(be.A))
        return KeccakR1CS(n_constraints=len(be.A), n_signals=be.n, n_public=N_PUBLIC,
                          A=be.A, B=be.B, C=be.C, layout=layout)


def witness(r1cs_or_layout, message: bytes) -> List[int]:
    """The witness of ``message`` for a circuit of :func:`keccak_r1cs` (or
    its :class:`KeccakLayout`): every signal's value, the digest bits in
    signals 1..256; the ``circuit.keccak.witness`` span."""
    layout = getattr(r1cs_or_layout, "layout", r1cs_or_layout)
    message = bytes(message)
    if len(message) != layout.message_bytes:
        raise ValueError(f"a {len(message)}-byte message for a {layout.message_bytes}-byte circuit")
    with span("circuit.keccak.witness"):
        be = _Values(message)
        _walk(be, layout.message_bytes, layout.rounds)
    if len(be.w) != layout.n_signals:
        raise AssertionError(f"{len(be.w)} values for {layout.n_signals} signals")
    return be.w


def digest(w: List[int]) -> bytes:
    """The digest that a witness's public signals hold."""
    return bytes(int("".join(str(b) for b in w[1 + 8 * i : 9 + 8 * i]), 2) for i in range(32))
