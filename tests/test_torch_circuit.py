"""The port's flat-code compiler (``circuitcompiler``), its native bridge and
``SparseR1CS.from_circuit`` held against the JAX package's, which is pure
Python here and costs no compile: the same parse, signals, constraints,
dense and sparse R1CS and witness on every ``circuitexamples/`` file, and
the same sparse system on a 300-link chain (the C++ witness path).
"""

import os
import random

import pytest

from go_snark_study_tpu import circuitcompiler as jcc
from go_snark_study_tpu.synthetic import SparseR1CS as JaxSparseR1CS
from go_snark_study_tpu_torch import circuitcompiler as pcc
from go_snark_study_tpu_torch import native
from go_snark_study_tpu_torch.bn128.constants import R
from go_snark_study_tpu_torch.synthetic import SparseR1CS

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "circuitexamples")

# file -> (private inputs, public inputs); None: the file has no main
INPUTS = {
    "factor.circuit": ([7, 6], [42]),
    "function.circuit": ([3], [35]),
    "import-example.circuit": ([3], [35]),
    "imported-example.circuit": None,
    "test.circuit": ([3], [35]),
}

# every operator, a literal on either side, and Euclidean division
OPS_SOURCE = """
func main(private a, private b, public c):
	d = a - b
	e = d * 3
	f = 7 + e
	g = f / b
	h = g * a
	equals(c, h)
	out = 1 * 1
"""
OPS_INPUTS = ([11, 5], [55])


def _same_circuit(pc, jc):
    assert pc.signals == jc.signals
    assert (pc.n_vars, pc.n_public, pc.n_signals) == (jc.n_vars, jc.n_public, jc.n_signals)
    assert (pc.private_inputs, pc.public_inputs) == (jc.private_inputs, jc.public_inputs)
    assert [c.to_json() for c in pc.constraints] == [c.to_json() for c in jc.constraints]


def _same_compile(pc, jc, priv, pub):
    _same_circuit(pc, jc)
    assert pc.generate_r1cs_sparse() == jc.generate_r1cs_sparse()
    assert pc.generate_r1cs() == jc.generate_r1cs()
    assert pc.calculate_witness(priv, pub) == jc.calculate_witness(priv, pub)
    assert pc.calculate_witness(priv, pub, field_modulus=R) == jc.calculate_witness(priv, pub, field_modulus=R)


def test_examples_are_all_covered():
    assert sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".circuit")) == sorted(INPUTS)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_parse_file_matches_jax(name):
    path = os.path.join(EXAMPLES, name)
    if INPUTS[name] is None:
        with pytest.raises(pcc.ParseError) as got:
            pcc.parse_file(path)
        with pytest.raises(jcc.ParseError) as want:
            jcc.parse_file(path)
        assert str(got.value) == str(want.value)
        return
    _same_compile(pcc.parse_file(path), jcc.parse_file(path), *INPUTS[name])


def test_parse_source_matches_jax_on_every_operator():
    pc, jc = pcc.parse_source(OPS_SOURCE), jcc.parse_source(OPS_SOURCE)
    _same_compile(pc, jc, *OPS_INPUTS)
    assert pc.witness[pc.signals.index("h")] == 55


def test_constraint_json_roundtrip():
    pc = pcc.parse_file(os.path.join(EXAMPLES, "function.circuit"))
    for cons in pc.constraints:
        assert pcc.Constraint.from_json(cons.to_json()) == cons


def _chain_source(n_links: int):
    """Flat-code multiplication chain t_k = t_{k-1} * t_{k-2}: (source,
    private inputs, public inputs)."""
    rng = random.Random(7)
    s0, s1 = rng.randrange(2, R), rng.randrange(2, R)
    lines = ["func main(private s0, private s1, public out):"]
    a, b, va, vb = "s0", "s1", s0, s1
    for k in range(n_links):
        lines.append(f"t{k} = {a} * {b}")
        a, b, va, vb = b, f"t{k}", vb, va * vb % R
    lines.append(f"out = {b} * 1")
    return "\n".join(lines) + "\n", [s0, s1], [vb]


@pytest.fixture(scope="module")
def chain300():
    return _chain_source(300)


def test_from_circuit_matches_jax_on_300_link_chain(chain300):
    src, priv, pub = chain300
    pc, jc = pcc.parse_source(src), jcc.parse_source(src)
    pw = pc.calculate_witness(priv, pub, field_modulus=R)
    assert pw == jc.calculate_witness(priv, pub, field_modulus=R)
    got, want = SparseR1CS.from_circuit(pc, witness=pw), JaxSparseR1CS.from_circuit(jc)
    assert (got.n_constraints, got.n_signals, got.n_public) == (301, want.n_signals, want.n_public)
    assert (got.A, got.B, got.C, got.witness) == (want.A, want.B, want.C, want.witness)
    assert got.check()
    assert got.row_evals() == want.row_evals()
    # through the dense R1CS: the same system
    pc2 = pcc.parse_source(src)
    pc2.calculate_witness(priv, pub, field_modulus=R)
    pc2.generate_r1cs()
    dense = SparseR1CS.from_circuit(pc2)
    assert (dense.A, dense.B, dense.C) == (got.A, got.B, got.C)


def test_native_and_python_routes_agree(chain300, monkeypatch):
    """The C++ witness evaluator and sparse matvec against the Python loops,
    on the chain (>= 256 constraints: the native witness path) and on a
    system with negative coefficients."""
    if not native.available():
        pytest.skip("the native library could not be built here (no make or g++)")
    src, priv, pub = chain300
    pc = pcc.parse_source(src)
    seeded = [1, pub[0], priv[0], priv[1]] + [0] * (len(pc.signals) - 4)
    w_native = pc._witness_native(seeded, R)
    assert w_native == pc.calculate_witness(priv, pub, field_modulus=R)
    systems = []
    for source, inputs in ((src, (priv, pub)), (OPS_SOURCE, OPS_INPUTS)):
        circuit = pcc.parse_source(source)
        circuit.calculate_witness(*inputs, field_modulus=R)
        systems.append(SparseR1CS.from_circuit(circuit))
    assert any(v > R // 2 for row in systems[1].A for v in row.values())  # a negative coefficient
    native_evals = [s._row_evals_native() for s in systems]
    assert None not in native_evals
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        assert pcc.parse_source(src).calculate_witness(priv, pub, field_modulus=R) == w_native
        for sys_, want in zip(systems, native_evals):
            assert sys_.row_evals() == want
