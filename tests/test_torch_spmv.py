"""The prover's three sparse products as one SpMV over the system's rows
(``go_snark_study_tpu_torch/ops/r1cs_spmv.py``), on the CPU: the plain
version of the kernel against the Python ints of ``SparseR1CS.row_evals``
entered by ``FieldKernels.pack_python`` and against the host products
(``SparseR1CS._products_into``: C++ where the library is built and every
coefficient fits its slot) entered by ``pack_bytes``; then
``FastGroth16._prove_inputs`` on ``device="cpu"`` against the same, with its
route counter and the kernel's launch count.  The systems: the
multiplication chain (every coefficient 1), a DSL circuit (negative and
fractional coefficients), circomlib's SHA-256 cut to a 4-byte message and 2
rounds (BinSum rows of 65 and more terms, ±2^k, −1, constants on signal 0),
and a seeded random system (coefficients above 2^63 and p − 1, an empty
row, a 200-term row, 37 constraints).  Imports no JAX: ``test_torch_gpu.py``
holds the kernel to the plain version on the card over these systems.
"""

import random

import numpy as np
import pytest
import torch

from go_snark_study_tpu_torch import circuitcompiler as pcc
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.circuits import sha256
from go_snark_study_tpu_torch.models.groth16_fast import DevicePk, FastGroth16, _next_pow2
from go_snark_study_tpu_torch.ops import r1cs_spmv as sp
from go_snark_study_tpu_torch.ops.limbs import bytes_to_rows, ints_to_limbs_np
from go_snark_study_tpu_torch.synthetic import SparseR1CS, mul_chain_r1cs

torch.set_num_threads(1)

CASES = ("mul_chain", "dsl", "sha256_2rounds", "random")
DSL_SOURCE = """
func main(private a, private b, public c):
	d = a - b
	e = d * 3
	f = 7 + e
	g = f / b
	h = g * a
	equals(c, h)
	out = 1 * 1
"""
DSL_INPUTS = ([11, 5], [55])


def make_system(name: str) -> SparseR1CS:
    """One of ``CASES``, with its witness; each satisfies its rows except
    the random one, whose witness is random."""
    if name == "mul_chain":
        return mul_chain_r1cs(40, seed=5)
    if name == "dsl":
        circuit = pcc.parse_source(DSL_SOURCE)
        circuit.calculate_witness(*DSL_INPUTS, field_modulus=C.R)
        return SparseR1CS.from_circuit(circuit)
    if name == "sha256_2rounds":
        r1cs = sha256.sha256_r1cs(4, rounds=2)
        r1cs.witness = sha256.witness(r1cs, b"abcd")
        return r1cs
    rng = random.Random(21)
    m, rows = 300, 37
    pick = lambda: rng.choice([1, 2, C.R - 1, C.R - 2, (1 << 63) + 5, (1 << 64) - 1, rng.randrange(C.R)])
    row = lambda k: {i: pick() for i in rng.sample(range(m), k)}
    A, B, Cm = ([row(rng.randrange(4)) for _ in range(rows)], [row(rng.randrange(40)) for _ in range(rows)],
                [row(rng.randrange(3)) for _ in range(rows)])
    A[5], B[3] = {}, row(200)
    return SparseR1CS(n_constraints=rows, n_signals=m, n_public=2, A=A, B=B, C=Cm,
                      witness=[rng.randrange(C.R) for _ in range(m)])


@pytest.fixture(scope="module")
def fast():
    return FastGroth16(device="cpu")


@pytest.fixture(scope="module")
def systems():
    return {name: make_system(name) for name in CASES}


def _host_products(r1cs, fast, n):
    """(the witness bytes, the three host products entered by K2's plain
    version) as the prover took them before the SpMV."""
    w = np.empty(32 * len(r1cs.witness), dtype=np.uint8)
    outs = tuple(np.empty(32 * len(rows), dtype=np.uint8) for rows in (r1cs.A, r1cs.B, r1cs.C))
    r1cs._witness_into(w)
    r1cs._products_into(w, outs)
    return w, [fast.Kr.pack_bytes(o.tobytes(), lanes=n) for o in outs]


@pytest.mark.parametrize("name", CASES)
def test_products_are_the_host_products(fast, systems, name):
    r1cs = systems[name]
    n = _next_pow2(r1cs.n_constraints)
    if name == "sha256_2rounds":
        coeffs = {v for rows in (r1cs.A, r1cs.B, r1cs.C) for row in rows for v in row.values()}
        assert {C.R - 1, 2, 1 << 31} <= coeffs and max(map(len, r1cs.C)) > sp.WARP
        assert any(0 in row for rows in (r1cs.A, r1cs.B, r1cs.C) for row in rows)
    if name == "random":
        assert r1cs._csr() is None and n != r1cs.n_constraints and max(map(len, r1cs.B)) == 200
    want_py = [torch.from_numpy(fast.Kr.pack_python(v + [0] * (n - len(v)))) for v in r1cs._row_evals_python()]
    w, want_host = _host_products(r1cs, fast, n)
    assert all(torch.equal(x, y) for x, y in zip(want_host, want_py))

    csr = sp.row_csr(r1cs, n, "cpu")
    assert sp.row_csr(r1cs, n, "cpu") is csr  # kept on the system
    assert csr.long_rows.tolist() == [j for j, ln in enumerate(torch.diff(csr.indptr).tolist()) if ln > sp.WARP]
    got = sp.r1cs_spmv_plain(csr, bytes_to_rows(torch.from_numpy(w), "cpu"))
    assert got.shape == (3, 8, n) and all(torch.equal(got[k], want_py[k]) for k in range(3))

    lo, m = r1cs.n_public + 1, r1cs.n_signals
    dpk = DevicePk(n=n, m=m, lo=lo, m_pad=fast._pad_for(m), mp_pad=fast._pad_for(m - lo), n_pad=fast._pad_for(n))
    launches = sp.SPMV.launches
    w_limbs, wp_limbs, h_in = fast._prove_inputs(r1cs, dpk)
    wv = [x % C.R for x in r1cs.witness]
    assert torch.equal(w_limbs, torch.from_numpy(ints_to_limbs_np(wv + [0] * (dpk.m_pad - m))))
    assert torch.equal(wp_limbs, torch.from_numpy(ints_to_limbs_np(wv[lo:] + [0] * (dpk.mp_pad - m + lo))))
    assert len(h_in) == 3 and all(torch.equal(x, y) for x, y in zip(h_in, want_py))
    assert sp.SPMV.launches == launches  # a CPU tensor takes the plain version
