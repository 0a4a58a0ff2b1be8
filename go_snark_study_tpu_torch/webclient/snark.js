/* go-snark-tpu browser client: CLIENT-SIDE proving and verification.
 *
 * Reference parity: the reference compiles its Go prover to wasm and runs it
 * in the page (wasm/go-snark-wasm-wrapper.go:21-26 registers generateProofs /
 * verifyProofs / grothGenerateProofs / grothVerifyProofs as JS globals taking
 * stringified JSON).  This file is the framework's native-JS equivalent (a
 * copy of go_snark_study_tpu/webclient/snark.js, served by the PyTorch port's
 * server at /snark.js):
 * the same four functions, the same decimal *String wire dialect
 * (utils/base10parsers.go shapes), implemented over BigInt — witness
 * computation (integer semantics incl. Go-Euclidean division,
 * circuit.go:158-186), H(x) = P(x)/Z(x) long division (r1csqap.go:70-84),
 * the Pinocchio 8-sum prover (snark.go:254-289), the Groth16 prover with
 * fresh r,s (groth16.go:225-279), and FULL in-browser verification via an
 * optimal-ate BN128 pairing (bn128.go:179-421) with naive final
 * exponentiation like the reference's (fq12.go:139-156).
 *
 * No external dependencies; exports `gosnark` (window.gosnark in browsers).
 */
"use strict";

// ---------------------------------------------------------------- fields
const Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583n;
const R = 21888242871839275222246405745257275088548364400416034343698204186575808495617n;
const ATE_LOOP = 29793968203157093288n; // 6x+2 (bn128.go:122)
const FINAL_EXP = (Q ** 12n - 1n) / R; // (q^12-1)/r (bn128.go:169)

const mod = (a, m) => ((a % m) + m) % m;
const addq = (a, b) => mod(a + b, Q);
const subq = (a, b) => mod(a - b, Q);
const mulq = (a, b) => mod(a * b, Q);
function powmod(b, e, m) {
  let r = 1n;
  b = mod(b, m);
  while (e > 0n) {
    if (e & 1n) r = (r * b) % m;
    b = (b * b) % m;
    e >>= 1n;
  }
  return r;
}
const invq = (a) => powmod(a, Q - 2n, Q);
const invr = (a) => powmod(a, R - 2n, R);

// Fq2 = Fq[u]/(u^2+1): [a0, a1]
const f2 = {
  zero: () => [0n, 0n],
  one: () => [1n, 0n],
  isZero: (a) => a[0] === 0n && a[1] === 0n,
  eq: (a, b) => a[0] === b[0] && a[1] === b[1],
  add: (a, b) => [addq(a[0], b[0]), addq(a[1], b[1])],
  sub: (a, b) => [subq(a[0], b[0]), subq(a[1], b[1])],
  neg: (a) => [subq(0n, a[0]), subq(0n, a[1])],
  conj: (a) => [a[0], subq(0n, a[1])],
  scale: (a, k) => [mulq(a[0], k), mulq(a[1], k)],
  mul: (a, b) => [
    subq(mulq(a[0], b[0]), mulq(a[1], b[1])),
    addq(mulq(a[0], b[1]), mulq(a[1], b[0])),
  ],
  sq: (a) => f2.mul(a, a),
  inv: (a) => {
    const n = invq(addq(mulq(a[0], a[0]), mulq(a[1], a[1])));
    return [mulq(a[0], n), subq(0n, mulq(a[1], n))];
  },
  exp: (a, e) => {
    let r = f2.one();
    while (e > 0n) {
      if (e & 1n) r = f2.mul(r, a);
      a = f2.sq(a);
      e >>= 1n;
    }
    return r;
  },
};
const XI = [9n, 1n]; // Fq6 = Fq2[v]/(v^3 - xi) (bn128.go:90-93)

// Fq6: [c0, c1, c2] of Fq2
const f6 = {
  zero: () => [f2.zero(), f2.zero(), f2.zero()],
  one: () => [f2.one(), f2.zero(), f2.zero()],
  eq: (a, b) => f2.eq(a[0], b[0]) && f2.eq(a[1], b[1]) && f2.eq(a[2], b[2]),
  add: (a, b) => [f2.add(a[0], b[0]), f2.add(a[1], b[1]), f2.add(a[2], b[2])],
  mulByV: (a) => [f2.mul(a[2], XI), a[0], a[1]], // * v
  mul: (a, b) => {
    const t = [f6.zero()[0], f2.zero(), f2.zero(), f2.zero(), f2.zero()];
    const acc = [f2.zero(), f2.zero(), f2.zero(), f2.zero(), f2.zero()];
    for (let i = 0; i < 3; i++)
      for (let j = 0; j < 3; j++)
        acc[i + j] = f2.add(acc[i + j], f2.mul(a[i], b[j]));
    return [
      f2.add(acc[0], f2.mul(acc[3], XI)),
      f2.add(acc[1], f2.mul(acc[4], XI)),
      acc[2],
    ];
  },
};

// Fq12 = Fq6[w]/(w^2 - v): [a, b] = a + b*w
const f12 = {
  one: () => [f6.one(), f6.zero()],
  eq: (x, y) => f6.eq(x[0], y[0]) && f6.eq(x[1], y[1]),
  mul: (x, y) => {
    const ac = f6.mul(x[0], y[0]);
    const bd = f6.mul(x[1], y[1]);
    const ad = f6.mul(x[0], y[1]);
    const bc = f6.mul(x[1], y[0]);
    return [f6.add(ac, f6.mulByV(bd)), f6.add(ad, bc)];
  },
  sq: (x) => f12.mul(x, x),
  exp: (x, e) => {
    let r = f12.one();
    while (e > 0n) {
      if (e & 1n) r = f12.mul(r, x);
      x = f12.sq(x);
      e >>= 1n;
    }
    return r;
  },
};

// ------------------------------------------------------------ curve groups
// Generic Jacobian ops over a coordinate field F (Fq for G1, Fq2 for G2).
function makeGroup(F) {
  const isInf = (p) => F.isZero(p[2]);
  const G = {
    zero: () => [F.zero(), F.one(), F.zero()],
    isZero: isInf,
    neg: (p) => [p[0], F.neg(p[1]), p[2]],
    double: (p) => {
      if (isInf(p)) return p;
      // dbl-2009-l (same formula family as bn128/g1.go:101-138)
      const A = F.sq(p[0]);
      const B = F.sq(p[1]);
      const C = F.sq(B);
      let D = F.sub(F.sq(F.add(p[0], B)), F.add(A, C));
      D = F.add(D, D);
      const E = F.add(F.add(A, A), A);
      const Fv = F.sq(E);
      const X = F.sub(Fv, F.add(D, D));
      let c8 = F.add(C, C);
      c8 = F.add(c8, c8);
      c8 = F.add(c8, c8);
      const Y = F.sub(F.mul(E, F.sub(D, X)), c8);
      const Z = F.mul(F.add(p[1], p[1]), p[2]);
      return [X, Y, Z];
    },
    add: (p, q) => {
      if (isInf(p)) return q;
      if (isInf(q)) return p;
      // add-2007-bl (bn128/g1.go:32-89)
      const Z1Z1 = F.sq(p[2]);
      const Z2Z2 = F.sq(q[2]);
      const U1 = F.mul(p[0], Z2Z2);
      const U2 = F.mul(q[0], Z1Z1);
      const S1 = F.mul(F.mul(p[1], q[2]), Z2Z2);
      const S2 = F.mul(F.mul(q[1], p[2]), Z1Z1);
      if (F.eq(U1, U2)) {
        if (F.eq(S1, S2)) return G.double(p);
        return G.zero();
      }
      const H = F.sub(U2, U1);
      const I = F.sq(F.add(H, H));
      const J = F.mul(H, I);
      let rr = F.sub(S2, S1);
      rr = F.add(rr, rr);
      const V = F.mul(U1, I);
      const X = F.sub(F.sub(F.sq(rr), J), F.add(V, V));
      let s1j = F.mul(S1, J);
      s1j = F.add(s1j, s1j);
      const Y = F.sub(F.mul(rr, F.sub(V, X)), s1j);
      // Z3 = H * ((Z1+Z2)^2 - Z1Z1 - Z2Z2) = 2 Z1 Z2 H
      return [X, Y, F.mul(H, F.sub(F.sq(F.add(p[2], q[2])), F.add(Z1Z1, Z2Z2)))];
    },
    mul: (p, k) => {
      let r = G.zero();
      let b = p;
      k = mod(k, R);
      while (k > 0n) {
        if (k & 1n) r = G.add(r, b);
        b = G.double(b);
        k >>= 1n;
      }
      return r;
    },
    affine: (p) => {
      if (isInf(p)) return null;
      const zi = F.inv(p[2]);
      const zi2 = F.sq(zi);
      return [F.mul(p[0], zi2), F.mul(p[1], F.mul(zi2, zi))];
    },
    msm: (points, scalars) => {
      // serial double-and-add sum, exactly the reference prover's loop
      // shape (snark.go:265-286) — browser circuits are small
      let acc = G.zero();
      for (let i = 0; i < scalars.length; i++)
        acc = G.add(acc, G.mul(points[i], scalars[i]));
      return acc;
    },
  };
  return G;
}
const fqOps = {
  zero: () => 0n,
  one: () => 1n,
  isZero: (a) => a === 0n,
  eq: (a, b) => a === b,
  add: addq,
  sub: subq,
  neg: (a) => subq(0n, a),
  mul: mulq,
  sq: (a) => mulq(a, a),
  inv: invq,
};
const G1 = makeGroup(fqOps);
const G2 = makeGroup(f2);
const G1_GEN = [1n, 2n, 1n];
const G2_GEN = [
  [
    10857046999023057135944570762232829481370756359578518086990519993285655852781n,
    11559732032986387107991004021392285783925812861821192530917403151452391805634n,
  ],
  [
    8495653923123431417604973247489272438418190587263600148770280649306958101930n,
    4082367875863433681332203403145435568316851327593401208105741076214120093531n,
  ],
  [1n, 0n],
];

// ------------------------------------------------------------- pairing
// Frobenius twist coefficients: gamma1j = xi^(j(q-1)/6) in Fq2
const G1F = f2.exp(XI, (Q - 1n) / 6n);
const GAMMA12 = f2.sq(G1F);
const GAMMA13 = f2.mul(GAMMA12, G1F);
const GAMMA22 = f2.mul(GAMMA12, f2.conj(GAMMA12)); // in Fq (imag = 0)
const GAMMA23 = f2.mul(GAMMA13, f2.conj(GAMMA13));

// sparse line value yp + (-lam*xp) w + (lam*x - y) w^3 as an Fq12 element
function lineValue(lam, x, y, xp, yp) {
  const a = [[yp, 0n], f2.zero(), f2.zero()];
  const b = [f2.scale(f2.neg(lam), xp), f2.sub(f2.mul(lam, x), y), f2.zero()];
  return [a, b];
}

function pairing(p1jac, p2jac) {
  // e(P, Q) with P in G1, Q in G2 (Jacobian in, affine internally);
  // identity on either side pairs to 1 (degenerate inputs must not crash
  // the verifier equations).
  const P = G1.affine(p1jac);
  const Qa = G2.affine(p2jac);
  if (P === null || Qa === null) return f12.one();
  const [xp, yp] = P;
  let [tx, ty] = Qa;
  let f = f12.one();
  const bits = ATE_LOOP.toString(2);
  for (let i = 1; i < bits.length; i++) {
    // doubling step: lam = 3x^2 / 2y
    const lam = f2.mul(
      f2.scale(f2.sq(tx), 3n),
      f2.inv(f2.scale(ty, 2n))
    );
    f = f12.mul(f12.sq(f), lineValue(lam, tx, ty, xp, yp));
    const x3 = f2.sub(f2.sq(lam), f2.scale(tx, 2n));
    ty = f2.sub(f2.mul(lam, f2.sub(tx, x3)), ty);
    tx = x3;
    if (bits[i] === "1") {
      const st = addStep(tx, ty, Qa[0], Qa[1], xp, yp);
      f = f12.mul(f, st.l);
      tx = st.x;
      ty = st.y;
    }
  }
  // two Frobenius-twisted additions (bn128.go:244-259)
  const q1 = [f2.mul(f2.conj(Qa[0]), GAMMA12), f2.mul(f2.conj(Qa[1]), GAMMA13)];
  const q2 = [f2.mul(Qa[0], GAMMA22), f2.neg(f2.mul(Qa[1], GAMMA23))]; // -pi^2(Q)
  let st = addStep(tx, ty, q1[0], q1[1], xp, yp);
  f = f12.mul(f, st.l);
  tx = st.x;
  ty = st.y;
  st = addStep(tx, ty, q2[0], q2[1], xp, yp);
  f = f12.mul(f, st.l);
  // final exponentiation, naive full-exponent square-and-multiply exactly
  // like the reference (bn128.go:418-421, fq12.go:139-156)
  return f12.exp(f, FINAL_EXP);
}

function addStep(x1, y1, x2, y2, xp, yp) {
  if (f2.eq(x1, x2) && f2.eq(y1, y2)) {
    const lam = f2.mul(f2.scale(f2.sq(x1), 3n), f2.inv(f2.scale(y1, 2n)));
    const x3 = f2.sub(f2.sq(lam), f2.scale(x1, 2n));
    return {
      l: lineValue(lam, x1, y1, xp, yp),
      x: x3,
      y: f2.sub(f2.mul(lam, f2.sub(x1, x3)), y1),
    };
  }
  const lam = f2.mul(f2.sub(y2, y1), f2.inv(f2.sub(x2, x1)));
  const x3 = f2.sub(f2.sub(f2.sq(lam), x1), x2);
  return {
    l: lineValue(lam, x1, y1, xp, yp),
    x: x3,
    y: f2.sub(f2.mul(lam, f2.sub(x1, x3)), y1),
  };
}

// --------------------------------------------------- witness + polynomials
function goDiv(x, y) {
  // Go big.Int.Div: Euclidean division, remainder in [0, |y|)
  // (circuit.go:176-183 uses it for the '/' op; witness math is raw ints).
  // BigInt '/' truncates toward zero -> make it floor, then Euclidean.
  let q = x / y;
  let r = x % y;
  if (r !== 0n && (r < 0n) !== (y < 0n)) {
    q -= 1n; // floor
    r += y;
  }
  if (r !== 0n && y < 0n) q += 1n; // Euclidean: remainder >= 0
  return q;
}

function isValue(s) {
  return /^[0-9]+$/.test(s) ? BigInt(s) : null;
}

function calculateWitness(circuit, privInputs, pubInputs) {
  // circuit.go:158-186 raw-integer semantics
  const signals = circuit.Signals;
  const idx = new Map(signals.map((s, i) => [s, i]));
  const w = new Array(signals.length).fill(0n);
  w[0] = 1n;
  pubInputs.forEach((x, i) => (w[1 + i] = x));
  privInputs.forEach((x, i) => (w[1 + pubInputs.length + i] = x));
  const grab = (v) => {
    const val = isValue(v);
    return val !== null ? val : w[idx.get(v)];
  };
  for (const cons of circuit.Constraints) {
    const op = cons.Op;
    if (op === "in") continue;
    const v1 = grab(cons.V1);
    const v2 = grab(cons.V2);
    let r;
    if (op === "+") r = v1 + v2;
    else if (op === "-") r = v1 - v2;
    else if (op === "*") r = v1 * v2;
    else if (op === "/") r = goDiv(v1, v2);
    else continue;
    w[idx.get(cons.Out)] = r;
  }
  return w;
}

function polyDivQuot(px, z) {
  // long division over Fr, quotient only (r1csqap.go:70-84)
  const q = new Array(px.length - z.length + 1).fill(0n);
  let rem = px.map((c) => mod(c, R));
  const zl = z.map((c) => mod(c, R));
  const leadInv = invr(zl[zl.length - 1]);
  while (rem.length >= zl.length) {
    const lead = mod(rem[rem.length - 1] * leadInv, R);
    const pos = rem.length - zl.length;
    q[pos] = lead;
    const next = rem.slice(0, rem.length - 1);
    for (let i = 0; i < zl.length - 1; i++)
      next[pos + i] = mod(next[pos + i] - lead * zl[i], R);
    rem = next;
  }
  return q;
}

function randFr() {
  // rejection sampling below R (fixes the reference's biased Fq.Rand,
  // fq.go:121-128)
  const buf = new Uint8Array(32);
  // r/s are the zero-knowledge blinding scalars: a non-CSPRNG here can
  // leak witness information, so a missing crypto API is a hard error
  // (every supported browser/Node runtime has crypto.getRandomValues).
  if (typeof crypto === "undefined" || !crypto.getRandomValues)
    throw new Error("no CSPRNG available (crypto.getRandomValues required)");
  const rand = (b) => crypto.getRandomValues(b);
  for (;;) {
    rand(buf);
    let x = 0n;
    for (let i = 0; i < 32; i++) x = (x << 8n) | BigInt(buf[i]);
    x &= (1n << 254n) - 1n;
    if (x < R) return x;
  }
}

// ------------------------------------------------------------ wire codecs
const S = (x) => x.toString();
const I = (s) => BigInt(s);
const p3 = (p) => [S(p[0]), S(p[1]), S(p[2])];
const p3i = (a) => [I(a[0]), I(a[1]), I(a[2])];
const p32 = (p) => p.map((c) => [S(c[0]), S(c[1])]);
const p32i = (a) => a.map((c) => [I(c[0]), I(c[1])]);
const arri = (a) => (a || []).map(I);
const arrp3i = (a) => (a || []).map(p3i);
const arrp32i = (a) => (a || []).map(p32i);

// ------------------------------------------------------------- protocols
function pinocchioProve(circuit, pk, w, px) {
  // snark.go:254-289
  const lo = circuit.NPublic + 1;
  const hi = circuit.NVars;
  const wAll = w.slice(0, hi).map((x) => mod(x, R));
  const wPriv = wAll.slice(lo);
  const hx = polyDivQuot(px, pk.Z);
  return {
    PiA: p3(G1.msm(pk.A.slice(lo, hi), wPriv)),
    PiAp: p3(G1.msm(pk.Ap.slice(lo, hi), wPriv)),
    PiB: p32(G2.msm(pk.B.slice(0, hi), wAll)),
    PiBp: p3(G1.msm(pk.Bp.slice(0, hi), wAll)),
    PiC: p3(G1.msm(pk.C.slice(0, hi), wAll)),
    PiCp: p3(G1.msm(pk.Cp.slice(0, hi), wAll)),
    PiH: p3(G1.msm(pk.G1T.slice(0, hx.length), hx)),
    PiKp: p3(G1.msm(pk.Kp.slice(0, hi), wAll)),
  };
}

function pinocchioVerify(vk, proof, publics) {
  // the five checks / 10 pairings (snark.go:292-368)
  const e = pairing;
  const piA = p3i(proof.PiA), piAp = p3i(proof.PiAp);
  const piB = p32i(proof.PiB), piBp = p3i(proof.PiBp);
  const piC = p3i(proof.PiC), piCp = p3i(proof.PiCp);
  const piH = p3i(proof.PiH), piKp = p3i(proof.PiKp);
  if (!f12.eq(e(piA, vk.Vka), e(piAp, G2_GEN))) return false;
  if (!f12.eq(e(vk.Vkb, piB), e(piBp, G2_GEN))) return false;
  if (!f12.eq(e(piC, vk.Vkc), e(piCp, G2_GEN))) return false;
  let vkx = vk.IC[0];
  publics.forEach((s, i) => {
    vkx = G1.add(vkx, G1.mul(vk.IC[i + 1], s));
  });
  const vkxPiA = G1.add(vkx, piA);
  if (
    !f12.eq(e(vkxPiA, piB), f12.mul(e(piH, vk.Vkz), e(piC, G2_GEN)))
  )
    return false;
  const piApiC = G1.add(vkxPiA, piC);
  const lhs = f12.mul(e(piApiC, vk.G2Kbg), e(vk.G1Kbg, piB));
  if (!f12.eq(lhs, e(piKp, vk.G2Kg))) return false;
  return true;
}

function grothProve(circuit, pk, w, px) {
  // groth16.go:225-279 with fresh r, s
  const lo = circuit.NPublic + 1;
  const hi = circuit.NVars;
  const wAll = w.slice(0, hi).map((x) => mod(x, R));
  const wPriv = wAll.slice(lo);
  const r = randFr();
  const s = randFr();
  let piA = G1.msm(pk.G1.At.slice(0, hi), wAll);
  let piBG1 = G1.msm(pk.G1.BACGamma.slice(0, hi), wAll);
  let piB = G2.msm(pk.G2.BACGamma.slice(0, hi), wAll);
  let piC = G1.msm(pk.BACDelta.slice(lo, hi), wPriv);
  piA = G1.add(piA, pk.G1.Alpha);
  piA = G1.add(piA, G1.mul(pk.G1.Delta, r));
  piBG1 = G1.add(piBG1, pk.G1.Beta);
  piB = G2.add(piB, pk.G2.Beta);
  piBG1 = G1.add(piBG1, G1.mul(pk.G1.Delta, s));
  piB = G2.add(piB, G2.mul(pk.G2.Delta, s));
  const hx = polyDivQuot(px, pk.Z);
  piC = G1.add(piC, G1.msm(pk.PowersTauDelta.slice(0, hx.length), hx));
  piC = G1.add(piC, G1.mul(piA, s));
  piC = G1.add(piC, G1.mul(piBG1, r));
  piC = G1.add(piC, G1.mul(pk.G1.Delta, mod(-(r * s), R)));
  return { PiA: p3(piA), PiB: p32(piB), PiC: p3(piC) };
}

function grothVerify(vk, proof, publics) {
  // e(piA, piB) == e(alpha, beta) * e(icPub, gamma) * e(piC, delta)
  // (groth16.go:281-305)
  let ic = vk.IC[0];
  publics.forEach((s, i) => {
    ic = G1.add(ic, G1.mul(vk.IC[i + 1], s));
  });
  const lhs = pairing(p3i(proof.PiA), p32i(proof.PiB));
  const rhs = f12.mul(
    pairing(vk.Alpha, vk.Beta),
    f12.mul(pairing(ic, vk.Gamma), pairing(p3i(proof.PiC), vk.Delta))
  );
  return f12.eq(lhs, rhs);
}

// ---------------------------------------------------- the four JS globals
function generateProofs(circuitJson, setupJson, pxJson, inputsJson) {
  const circuit = JSON.parse(circuitJson);
  const sd = JSON.parse(setupJson).Pk;
  const pk = {
    G1T: arrp3i(sd.G1T),
    A: arrp3i(sd.A),
    B: arrp32i(sd.B),
    C: arrp3i(sd.C),
    Kp: arrp3i(sd.Kp),
    Ap: arrp3i(sd.Ap),
    Bp: arrp3i(sd.Bp),
    Cp: arrp3i(sd.Cp),
    Z: arri(sd.Z),
  };
  const px = arri(JSON.parse(pxJson));
  const priv = JSON.parse(inputsJson).map(I);
  const pubs = arri(circuit.Witness).slice(1, circuit.NPublic + 1);
  const w = calculateWitness(circuit, priv, pubs);
  return JSON.stringify(pinocchioProve(circuit, pk, w, px));
}

function verifyProofs(proofJson, setupJson, publicJson) {
  const vd = JSON.parse(setupJson).Vk;
  const vk = {
    Vka: p32i(vd.Vka),
    Vkb: p3i(vd.Vkb),
    Vkc: p32i(vd.Vkc),
    IC: arrp3i(vd.IC),
    G1Kbg: p3i(vd.G1Kbg),
    G2Kbg: p32i(vd.G2Kbg),
    G2Kg: p32i(vd.G2Kg),
    Vkz: p32i(vd.Vkz),
  };
  const ok = pinocchioVerify(
    vk,
    JSON.parse(proofJson),
    JSON.parse(publicJson).map(I)
  );
  return JSON.stringify({ verified: ok });
}

function grothGenerateProofs(circuitJson, setupJson, pxJson, inputsJson) {
  const circuit = JSON.parse(circuitJson);
  const sd = JSON.parse(setupJson).Pk;
  const pk = {
    BACDelta: arrp3i(sd.BACDelta),
    Z: arri(sd.Z),
    PowersTauDelta: arrp3i(sd.PowersTauDelta),
    G1: {
      Alpha: p3i(sd.G1.Alpha),
      Beta: p3i(sd.G1.Beta),
      Delta: p3i(sd.G1.Delta),
      At: arrp3i(sd.G1.At),
      BACGamma: arrp3i(sd.G1.BACGamma),
    },
    G2: {
      Beta: p32i(sd.G2.Beta),
      Delta: p32i(sd.G2.Delta),
      BACGamma: arrp32i(sd.G2.BACGamma),
    },
  };
  const px = arri(JSON.parse(pxJson));
  const priv = JSON.parse(inputsJson).map(I);
  const pubs = arri(circuit.Witness).slice(1, circuit.NPublic + 1);
  const w = calculateWitness(circuit, priv, pubs);
  return JSON.stringify(grothProve(circuit, pk, w, px));
}

function grothVerifyProofs(proofJson, setupJson, publicJson) {
  const vd = JSON.parse(setupJson).Vk;
  const vk = {
    IC: arrp3i(vd.IC),
    Alpha: p3i(vd.G1.Alpha),
    Beta: p32i(vd.G2.Beta),
    Gamma: p32i(vd.G2.Gamma),
    Delta: p32i(vd.G2.Delta),
  };
  const ok = grothVerify(
    vk,
    JSON.parse(proofJson),
    JSON.parse(publicJson).map(I)
  );
  return JSON.stringify({ verified: ok });
}

const gosnark = {
  generateProofs,
  verifyProofs,
  grothGenerateProofs,
  grothVerifyProofs,
  // internals exposed for testing
  _internals: { pairing, f12, f2, G1, G2, G1_GEN, G2_GEN, calculateWitness, polyDivQuot },
};
if (typeof window !== "undefined") window.gosnark = gosnark;
if (typeof module !== "undefined" && module.exports) module.exports = gosnark;
