"""The host group law's two long chains in C against the Python law.

``native.mul_scalar`` (``_JacobianGroup.mul_scalar``'s MSB-first
double-and-add) and ``native.combine_windows`` (``ops.msm.
combine_window_sums``'s Horner chain), both in ``native/gosnark_pyints.c``
over Montgomery limbs, G1 over Fq and G2 over Fq2, must return the Jacobian
triple the Python law of ``bn128/curve.py`` returns, integer for integer,
and the very input object where the law passes an operand through.  Each
case runs once through the library and once with it gone (the Python law),
on seeded points, and counts its chains in ``native.CHAINS``.
"""

import random

import pytest

from go_snark_study_tpu_torch import native
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.bn128 import default_bn128
from go_snark_study_tpu_torch.models.groth16 import Pk, assemble_proof
from go_snark_study_tpu_torch.models.context import default_context
from go_snark_study_tpu_torch.ops.msm import combine_window_sums

BN = default_bn128()
GROUPS = {"g1": BN.g1, "g2": BN.g2}


@pytest.fixture
def library():
    if not native._load_pyints():
        pytest.skip("the library of native/gosnark_pyints.c could not be built here (no C compiler)")


def _points(g, seed: int, n: int):
    rng = random.Random(seed)
    return [g.mul_scalar(g.g, rng.randrange(1, C.R)) for _ in range(n)]


def _identities(g):
    """The group's identity and a triple of other coordinates with z = 0,
    which the law also takes for the identity."""
    five, seven = ((5, 3), (7, 2)) if g is BN.g2 else (5, 7)
    return [g.zero(), (five, seven, g.F.zero())]


def _combine_windows(g, kind: str, seed: int):
    rng = random.Random(seed)
    pts = _points(g, seed, 6)
    zero, odd_zero = _identities(g)
    if kind == "mixed":  # random windows, the identity twice, two equal windows, a window as a list
        ws = [rng.choice(pts) for _ in range(14)] + [zero, pts[0], pts[0], odd_zero]
        rng.shuffle(ws)
        return ws + [list(pts[1])]
    if kind == "single-live":
        ws = [zero] * 20
        ws[rng.randrange(20)] = pts[2]
        return ws
    raise KeyError(kind)


def _case(group: str, name: str):
    """A callable that runs the case's chains and returns what they gave."""
    g = GROUPS.get(group)
    if name.startswith("mul-"):
        p = _points(g, 3, 1)[0]
        rng = random.Random(17)
        e = {"mul-0": 0, "mul-1": 1, "mul-2": 2, "mul-r-1": C.R - 1, "mul-2^255+1": 2**255 + 1,
             "mul-2^256-1": 2**256 - 1}.get(name)
        if name == "mul-random254":
            es = [rng.randrange(2**253, 2**254) for _ in range(3)]
            return lambda: [g.mul_scalar(p, e) for e in es]
        if name == "mul-identity":
            return lambda: [g.mul_scalar(z, e) for z in _identities(g) for e in (0, 1, 5)]
        if name == "mul-list-point":  # e = 1 passes the point itself through
            return lambda: [g.mul_scalar(list(p), e) for e in (1, 2, 3)]
        return lambda: g.mul_scalar(p, e)
    if name.startswith("add-"):
        # c = 1 over two windows: 2·w1 + w0, with w0 = ±2·w1 in other
        # Jacobian coordinates, so that add meets h = 0
        p = _points(g, 5, 1)[0]
        two_p = g.mul_scalar(g.double(g.double(p)), (C.R + 1) // 2)
        w0 = {"add-p+p": two_p, "add-p-p": g.neg(two_p), "add-identity": g.zero()}[name]
        assert w0 == g.zero() or w0[2] != g.double(p)[2]
        return lambda: (combine_window_sums(g, [w0, p], 1), combine_window_sums(g, [g.zero(), w0], 1),
                        combine_window_sums(g, [w0, w0], 0))
    if name.startswith("combine-"):
        _, c, kind = name.split("-", 2)
        ws = _combine_windows(g, kind, int(c))
        return lambda: combine_window_sums(g, ws, int(c))
    if name == "assemble_proof":
        ctx = default_context()
        p1, p2 = _points(BN.g1, 7, 8), _points(BN.g2, 7, 3)
        pk = Pk()
        pk.g1.alpha, pk.g1.beta, pk.g1.delta = p1[:3]
        pk.g2.beta, pk.g2.delta = p2[:2]
        rng = random.Random(23)
        r, s = rng.randrange(C.R), rng.randrange(C.R)
        return lambda: vars(assemble_proof(ctx, pk, r, s, p1[3], p1[4], p2[2], p1[5], p1[6]))
    raise KeyError(name)


MUL = ["mul-0", "mul-1", "mul-2", "mul-r-1", "mul-2^255+1", "mul-2^256-1", "mul-random254", "mul-identity",
       "mul-list-point"]
ADD = ["add-p+p", "add-p-p", "add-identity"]
COMBINE = [f"combine-{c}-{kind}" for c in (1, 4, 13, 16) for kind in ("mixed", "single-live")]
CASES = [(g, name) for g in GROUPS for name in MUL + ADD + COMBINE] + [("g1+g2", "assemble_proof")]


def _same(a, b) -> bool:
    """Equal, with the same container types all the way down."""
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return type(b) is dict and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _chains(run):
    before = dict(native.CHAINS)
    out = run()
    return out, {k: native.CHAINS[k] - before[k] for k in before}


@pytest.mark.parametrize("group,name", CASES, ids=[f"{g}-{n}" for g, n in CASES])
def test_native_chain_is_the_python_law(monkeypatch, library, group, name):
    run = _case(group, name)
    got, routes = _chains(run)
    assert routes["python"] == 0 and routes["native"] > 0, routes
    with monkeypatch.context() as m:
        m.setattr(native, "_load_pyints", lambda: False)
        want, law_routes = _chains(run)
    assert law_routes == {"native": 0, "python": routes["native"]}
    assert _same(got, want), (got, want)


def _forced(group: str, name: str):
    """(the input the C declines, the same value's native twin) and the chain."""
    g = GROUPS[group]
    p = _points(g, 11, 1)[0]
    q = C.Q
    big = (p[0] + q, p[1], p[2]) if g is BN.g1 else ((p[0][0], p[0][1] + q), p[1], p[2])
    if name == "coordinate>=q":
        return lambda: g.mul_scalar(big, 5), lambda: g.mul_scalar(p, 5)
    if name == "window>=q":
        return (lambda: combine_window_sums(g, [p, big], 4), lambda: combine_window_sums(g, [p, p], 4))
    if name == "scalar-bool":
        return lambda: g.mul_scalar(p, True), lambda: g.mul_scalar(p, 1)
    if name == "scalar-negative":  # the law's loop on -e: its bits, never a subtraction
        return lambda: g.mul_scalar(p, -6), None
    if name == "scalar>=2^256":
        return lambda: g.mul_scalar(p, 2**256 + 3), None
    if name == "no-library":
        return (lambda: (g.mul_scalar(p, C.R - 2), combine_window_sums(g, [p, g.zero(), p], 13)),
                lambda: (g.mul_scalar(p, C.R - 2), combine_window_sums(g, [p, g.zero(), p], 13)))
    raise KeyError(name)


FORCED = [(g, n) for g in GROUPS for n in ("coordinate>=q", "window>=q", "scalar-bool", "scalar-negative",
                                          "scalar>=2^256", "no-library")]


@pytest.mark.parametrize("group,name", FORCED, ids=[f"{g}-{n}" for g, n in FORCED])
def test_python_route_where_the_c_declines(monkeypatch, library, group, name):
    """Inputs the C does not take, or no library: the Python law runs them,
    counted under ``python``, and gives what the native route gives on the
    same value in canonical form."""
    run, twin = _forced(group, name)
    if name == "no-library":
        monkeypatch.setattr(native, "_load_pyints", lambda: False)
    got, routes = _chains(run)
    assert routes == {"native": 0, "python": 2 if name == "no-library" else 1}
    if twin is not None:
        monkeypatch.undo()
        want, twin_routes = _chains(twin)
        assert twin_routes["python"] == 0
        assert _same(got, want), (got, want)
    else:
        g = GROUPS[group]
        p = _points(g, 11, 1)[0]
        e = -6 if name == "scalar-negative" else 2**256 + 3
        acc = g.zero()
        for i in range(e.bit_length() - 1, -1, -1):
            acc = g.double(acc)
            if (e >> i) & 1:
                acc = g.add(acc, p)
        assert _same(got, acc)
