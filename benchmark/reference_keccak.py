"""The plain reference for a Keccak-256 circuit: the sponge over
Keccak-f[1600] in plain Python, its gates as R1CS rows and a witness,
written bit by bit from their equations; the Groth16 proof in closed form is
:class:`benchmark.reference_sha256.Groth16Proofs`.

Python integers, with BN254 from :mod:`benchmark.reference`; nothing of
``jax``, the JAX package or the prover's packages, and nothing that the
program made.

* :func:`keccak256`: Keccak-f[1600] by FIPS 202's step mappings on a 5 x 5
  array of 64-bit lanes, rate 136 bytes, Ethereum's padding byte 0x01
  (:func:`sponge` with 0x06 is ``hashlib.sha3_256``).
* :class:`KeccakCircuit`: each message byte range-checked by
  ``Num2Bits(8)``, the 256 digest bits public.  Signals ``[one, digest bits
  (the first byte's top bit first), message bytes, intermediates in gate
  order]``; a constant input gets no signal (a 1 is the constant one,
  signal 0; a 0 is left out), and a row whose A or B is then constant is
  multiplied out into C (a linear row, A = B = {}).  Gates, a bit at a
  time:
  ``XOR``: (2a)*b = a + b - out;
  chi's AND-NOT: (1 - b)*c = t;
  ``Num2Bits(8)``: o*(o - 1) = 0 for each output bit, then the linear row
  sum_k 2^k*o_k - byte = 0;
  iota's and the padding's constant 1 bits: XOR with the constant one (a
  linear row out = 1 - a); their 0 bits cost nothing.
  Block 1 is the state (its message bits are the bytes' Num2Bits outputs);
  later blocks XOR their bits in.  Each round: theta's column sums
  ((((a0 ^ a1) ^ a2) ^ a3) ^ a4) for each column, then the five D lanes
  C[x-1] ^ rot(C[x+1], 1), then a ^= D over the 25 lanes (index x + 5y);
  rho and pi move wires; chi lane by lane (its 64 AND-NOTs, then its 64
  XORs); iota.  The last round's outputs that are the digest's bits are
  the digest signals.
  :meth:`KeccakCircuit.witness` computes every signal from its inputs'
  values and holds the public bits to :func:`keccak256`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from benchmark.reference import R

N_PUBLIC = 256
RATE = 136
ONE = {0: 1}
ZERO: dict = {}
MASK = (1 << 64) - 1


# -- Keccak-f[1600], FIPS 202 section 3 ---------------------------------------
def _round_constants() -> List[int]:
    """RC of the 24 rounds: the LFSR of algorithm 5 run on from one round
    to the next, 7 output bits a round at positions 2^j - 1."""
    out, lfsr = [], 0x01
    for _ in range(24):
        rc = 0
        for j in range(7):
            if lfsr & 1:
                rc |= 1 << ((1 << j) - 1)
            lfsr = ((lfsr << 1) ^ 0x71) & 0xFF if lfsr & 0x80 else lfsr << 1
        out.append(rc)
    return out


def _rotation_offsets() -> List[List[int]]:
    """r[x][y] of algorithm 2 (rho)."""
    r = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        r[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return r


ROUND_CONSTANTS = _round_constants()
ROTATIONS = _rotation_offsets()


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & MASK


def keccak_f1600(A: List[List[int]], rounds: int = 24) -> List[List[int]]:
    """The first ``rounds`` rounds over A[x][y], 64-bit lanes."""
    for ir in range(rounds):
        C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
        D = [C[(x + 4) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        A = [[A[x][y] ^ D[x] for y in range(5)] for x in range(5)]
        # rho then pi: A'[x][y] = rot(A[(x + 3y) % 5][x])
        A = [[_rotl(A[(x + 3 * y) % 5][x], ROTATIONS[(x + 3 * y) % 5][x]) for y in range(5)] for x in range(5)]
        A = [[A[x][y] ^ ((A[(x + 1) % 5][y] ^ MASK) & A[(x + 2) % 5][y]) for y in range(5)] for x in range(5)]
        A[0][0] ^= ROUND_CONSTANTS[ir]
    return A


def _pad(message: bytes, first: int) -> bytes:
    p = bytearray(RATE - len(message) % RATE)
    p[0] ^= first
    p[-1] ^= 0x80
    return bytes(message) + bytes(p)


def sponge(message: bytes, first_pad: int, rounds: int = 24) -> bytes:
    """Rate-136 sponge, 32 bytes out: Keccak-256 with ``first_pad`` 0x01,
    SHA3-256 with 0x06."""
    data = _pad(message, first_pad)
    A = [[0] * 5 for _ in range(5)]
    for off in range(0, len(data), RATE):
        for k in range(RATE // 8):
            A[k % 5][k // 5] ^= int.from_bytes(data[off + 8 * k : off + 8 * k + 8], "little")
        A = keccak_f1600(A, rounds)
    return b"".join(A[k][0].to_bytes(8, "little") for k in range(4))


def keccak256(message: bytes) -> bytes:
    return sponge(message, 0x01)


# -- the circuit ---------------------------------------------------------------
def combo(*terms) -> dict:
    """sum of coefficient * linear combination, mod r, zeros dropped."""
    out: dict = {}
    for coef, lc in terms:
        for s, c in lc.items():
            out[s] = (out.get(s, 0) + coef * c) % R
    return {s: c for s, c in out.items() if c}


def digest_signal(i: int) -> int:
    """The signal of bit i of the digest, bit 7 - i % 8 of byte i // 8."""
    return 1 + i


def _digest_bit_of(x: int, z: int) -> int:
    """Digest bit index of bit z of lane (x, 0), x < 4: byte 8x + z // 8,
    its bit z % 8."""
    return 8 * (8 * x + z // 8) + 7 - z % 8


class KeccakCircuit:
    """The rows (``A``, ``B``, ``C``) for messages of ``message_bytes``
    bytes; ``rounds`` below 24 keeps each permutation's first rounds only
    (tests; not Keccak)."""

    def __init__(self, message_bytes: int, rounds: int = 24):
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
        bits are not :func:`keccak256` of it."""
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
        if self.rounds == 24 and digest(w) != keccak256(bytes(message)):
            raise ValueError("the witness's public bits are not keccak256 of the message")
        return w

    # -- signals and rows ----------------------------------------------------
    def _val(self, lc: dict) -> int:
        return sum(c * self._vals[s] for s, c in lc.items()) % R

    def _signal(self, value, fixed: Optional[int] = None) -> dict:
        """One output signal: a new one, or the digest signal ``fixed``."""
        if fixed is not None:
            if self._vals is not None:
                self._vals[fixed] = value
            return {fixed: 1}
        s = self._count
        self._count += 1
        if self._vals is not None:
            self._vals.append(value)
        return {s: 1}

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

    # -- gates, one bit each --------------------------------------------------
    def _xor(self, a: dict, b: dict, fixed: Optional[int] = None) -> dict:
        v = (self._val(a) ^ self._val(b)) if self._vals is not None else None
        out = self._signal(v, fixed)
        self._constraint(combo((2, a)), b, combo((1, a), (1, b), (-1, out)))
        return out

    def _andn(self, b: dict, c: dict) -> dict:
        v = ((1 - self._val(b)) * self._val(c)) if self._vals is not None else None
        t = self._signal(v)
        self._constraint(combo((1, ONE), (-1, b)), c, t)
        return t

    def _num2bits8(self, i: int) -> list:
        x = {1 + N_PUBLIC + i: 1}
        v = self._val(x) if self._vals is not None else 0
        out = [self._signal((v >> k) & 1) for k in range(8)]
        for o in out:
            self._constraint(o, combo((1, o), (-1, ONE)), ZERO)
        self._constraint(ZERO, ZERO, combo(*((1 << k, o) for k, o in enumerate(out)), (-1, x)))
        return out

    # -- lanes: lists of 64 bits, bit 0 the least significant ------------------
    def _xor_lane(self, a: list, b: list, fixed: Optional[list] = None) -> list:
        return [self._xor(a[z], b[z], fixed[z] if fixed else None) for z in range(64)]

    def _run(self) -> None:
        self._count = 1 + N_PUBLIC + self.message_bytes
        n = self.message_bytes
        # the padded stream, one bit list a byte: message bytes, then the
        # padding as constants
        stream = [self._num2bits8(i) for i in range(n)]
        padding = _pad(bytes(n % RATE), 0x01)[n % RATE :]
        stream += [[ONE if (p >> k) & 1 else ZERO for k in range(8)] for p in padding]
        blocks = len(stream) // RATE
        S: Optional[List[List[list]]] = None  # S[x][y]: a lane
        for blk in range(blocks):
            lanes = [[bit for byte in stream[blk * RATE + 8 * k : blk * RATE + 8 * k + 8] for bit in byte]
                     for k in range(RATE // 8)]
            if S is None:
                S = [[lanes[x + 5 * y] if x + 5 * y < len(lanes) else [ZERO] * 64 for y in range(5)]
                     for x in range(5)]
            else:
                for k, lane in enumerate(lanes):
                    x, y = k % 5, k // 5
                    # a message bit is XORed in, a padding 1 is XOR with the
                    # constant one, a padding 0 leaves the bit as it is
                    S[x][y] = [S[x][y][z] if lane[z] is ZERO else self._xor(S[x][y][z], lane[z]) for z in range(64)]
            for ir in range(self.rounds):
                last = blk == blocks - 1 and ir == self.rounds - 1
                S = self._round(S, ir, last)

    def _round(self, S, ir: int, last: bool):
        rot = lambda lane, k: [lane[(z - k) % 64] for z in range(64)]
        C = []
        for x in range(5):
            acc = self._xor_lane(S[x][0], S[x][1])
            for y in (2, 3, 4):
                acc = self._xor_lane(acc, S[x][y])
            C.append(acc)
        D = [self._xor_lane(C[(x + 4) % 5], rot(C[(x + 1) % 5], 1)) for x in range(5)]
        T = [[None] * 5 for _ in range(5)]
        for y in range(5):
            for x in range(5):
                T[x][y] = self._xor_lane(S[x][y], D[x])
        P = [[rot(T[(x + 3 * y) % 5][x], ROTATIONS[(x + 3 * y) % 5][x]) for y in range(5)] for x in range(5)]
        rc = ROUND_CONSTANTS[ir]
        out = [[None] * 5 for _ in range(5)]
        for y in range(5):
            for x in range(5):
                t = [self._andn(P[(x + 1) % 5][y][z], P[(x + 2) % 5][y][z]) for z in range(64)]
                fixed = None
                if last and y == 0 and x < 4:
                    # the digest's bits; lane (0, 0)'s set bits of RC are
                    # written by iota below
                    fixed = [None if x == 0 and (rc >> z) & 1 else digest_signal(_digest_bit_of(x, z))
                             for z in range(64)]
                out[x][y] = self._xor_lane(P[x][y], t, fixed)
        lane = out[0][0]
        out[0][0] = [self._xor(lane[z], ONE, digest_signal(_digest_bit_of(0, z)) if last else None)
                     if (rc >> z) & 1 else lane[z] for z in range(64)]
        return out


def digest(w: Sequence[int]) -> bytes:
    """The 32 bytes that a witness's public bits spell."""
    return bytes(sum(w[1 + 8 * i + k] << (7 - k) for k in range(8)) for i in range(32))
