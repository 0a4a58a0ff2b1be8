"""The port's host bridge held against the JAX package's.

Counterpart of ``tests/test_native.py``: ``NativeField.pack_ints`` /
``unpack_ints`` (the JAX bridge, in the port's (8, N) layout), the card
route of ``FieldKernels.pack`` (bytes, then a Montgomery product by R^2,
here K2's plain version), ``scalars_to_limbs`` / ``scalars_to_windows``,
``SparseR1CS._row_evals_bytes`` and the prover's input tensors, each bit
for bit against the JAX package or the Python route on the same seeded
values; the C encoder of ``ints_to_bytes`` / ``ints_into`` and its route
counter against the Python route.  The cases that need the C++ library
skip where it cannot be built, as the JAX test does.
"""

import re

import numpy as np
import pytest
import torch

from go_snark_study_tpu import circuitcompiler as jcc
from go_snark_study_tpu.native import NativeField as JaxNativeField
from go_snark_study_tpu.ops import msm as jmsm
from go_snark_study_tpu.ops.limbs import FieldKernels as JaxFieldKernels
from go_snark_study_tpu.synthetic import SparseR1CS as JaxSparseR1CS
from go_snark_study_tpu.synthetic import mul_chain_r1cs as jax_mul_chain_r1cs
from go_snark_study_tpu_torch import circuitcompiler as pcc
from go_snark_study_tpu_torch import native
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.interop import jax_to_port, port_to_jax
from go_snark_study_tpu_torch.models.groth16_fast import DevicePk, FastGroth16, _next_pow2
from go_snark_study_tpu_torch.ops import msm
from go_snark_study_tpu_torch.ops.limbs import FieldKernels, ints_to_limbs_np
from go_snark_study_tpu_torch.synthetic import SparseR1CS, mul_chain_r1cs

from test_torch_circuit import OPS_INPUTS, OPS_SOURCE

torch.set_num_threads(1)

FIELDS = {"fq": C.Q, "fr": C.R}
CASES = [(f, mont) for f in FIELDS for mont in (True, False)]
IDS = [f"{f}-{'mont' if mont else 'plain'}" for f, mont in CASES]


def _vals(p: int, seed: int, n: int = 300):
    """n seeded values below p, then the edges 0, 1, p-1, p, p+1, 2p+5, -1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**63, size=(n, 4), dtype=np.int64)
    xs = [int(sum(int(w) << (63 * k) for k, w in enumerate(row))) % p for row in words]
    return xs + [0, 1, p - 1, p, p + 1, 2 * p + 5, -1]


@pytest.fixture
def library():
    if not native.available():
        pytest.skip("the native library could not be built here (no make or g++)")


def _encode_inputs(name: str):
    r = C.R
    if name == "random4096":  # seeded: three in four below r, the rest anywhere in (-2^260, 2^260)
        rng = np.random.default_rng(11)
        words = rng.integers(0, 2**63, size=(4096, 5), dtype=np.int64)
        xs = [int(sum(int(w) << (63 * k) for k, w in enumerate(row))) for row in words]
        return [x % r if i % 4 else x % (2**261) - 2**260 for i, x in enumerate(xs)]
    return {"zero": [0], "one": [1], "r-1": [r - 1], "r": [r], "r+1": [r + 1], "2^256-1": [2**256 - 1],
            "2^300": [2**300], "minus-one": [-1], "bool": [True], "numpy-int64": [np.int64(5)], "empty": [],
            "tuple": (r - 1, 2, r + 3, -5, 0), "no-library": [0, 7, r - 1, r, -1, True]}[name]


ENCODE_CASES = ["zero", "one", "r-1", "r", "r+1", "2^256-1", "2^300", "minus-one", "bool", "numpy-int64", "empty",
                "tuple", "random4096", "no-library"]


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_encoder_is_the_python_route(monkeypatch, name):
    """``ints_to_bytes`` and ``ints_into`` (the C encoder, then the Python
    route item by item for what is not an exact int in [0, r)) against the
    Python route alone, byte for byte or by the same exception, and the
    route counter: each value once, under the route it took.  With the
    encoder's library gone every value takes the Python route."""
    xs = _encode_inputs(name)
    if name == "no-library":
        monkeypatch.setattr(native, "_load_pyints", lambda: False)
    try:
        want = b"".join((x % C.R).to_bytes(32, "little") for x in xs)
    except OverflowError as e:  # a numpy integer: x % r has no int64 result
        want = e
    on = name != "no-library" and bool(native._load_pyints())  # the library builds wherever a C compiler is
    native_n = sum(type(x) is int and 0 <= x < C.R for x in xs) if on else 0
    for route in ("bytes", "into"):
        before = dict(native.ENCODED)
        if isinstance(want, Exception):
            with pytest.raises(type(want), match=re.escape(str(want))):
                native.ints_to_bytes(xs, C.R) if route == "bytes" else \
                    native.ints_into(xs, C.R, np.empty(32 * len(xs), np.uint8))
            assert native.ENCODED == before
            continue
        if route == "bytes":
            got = native.ints_to_bytes(xs, C.R)
        else:
            buf = np.full(32 * len(xs), 0xA5, np.uint8)
            native.ints_into(xs, C.R, buf)
            got = buf.tobytes()
        assert type(got) is bytes and got == want, route
        assert native.ENCODED["native"] - before["native"] == native_n, route
        assert native.ENCODED["python"] - before["python"] == len(xs) - native_n, route


@pytest.mark.parametrize("field,mont", CASES, ids=IDS)
def test_pack_ints_matches_jax(library, field, mont):
    p = FIELDS[field]
    xs = _vals(p, 1)
    got = native.NativeField(p).pack_ints(xs, mont=mont)
    assert got.dtype == np.int32 and got.shape == (8, len(xs))
    np.testing.assert_array_equal(got, jax_to_port(JaxNativeField(p).pack_ints(xs, mont=mont)))
    np.testing.assert_array_equal(got, jax_to_port(JaxFieldKernels(p).pack_np(xs, mont=mont)))
    K = FieldKernels(p, "cpu")
    np.testing.assert_array_equal(got, K.pack_python(xs, mont))
    np.testing.assert_array_equal(got, K.pack_np(xs, mont))


@pytest.mark.parametrize("field,mont", CASES, ids=IDS)
def test_unpack_ints_roundtrips_and_matches_jax(library, field, mont):
    p = FIELDS[field]
    xs = _vals(p, 2)
    nf = native.NativeField(p)
    arr = nf.pack_ints(xs, mont=mont)
    got = nf.unpack_ints(arr, mont=mont)
    assert got == [x % p for x in xs]
    assert got == JaxNativeField(p).unpack_ints(port_to_jax(arr), mont=mont)


@pytest.mark.parametrize("field,mont", CASES, ids=IDS)
def test_pack_np_without_the_library_is_the_python_route(monkeypatch, field, mont):
    p = FIELDS[field]
    xs = _vals(p, 3)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(FieldKernels(p, "cpu").pack_np(xs, mont),
                                  jax_to_port(JaxFieldKernels(p).pack_np(xs, mont=mont)))


@pytest.mark.parametrize("field,mont", CASES, ids=IDS)
def test_card_route_is_the_python_route(field, mont):
    """``pack`` (bytes, then K2's plain version by R^2 on a CPU tensor) and
    ``pack_bytes`` with zero padding, against the Python Montgomery route."""
    p = FIELDS[field]
    xs = _vals(p, 4)
    K = FieldKernels(p, "cpu")
    want = torch.from_numpy(K.pack_python(xs, mont))
    assert torch.equal(K.pack(xs, mont), want)
    padded = K.pack_bytes(native.ints_to_bytes(xs, p), mont, lanes=len(xs) + 5)
    assert torch.equal(padded[:, : len(xs)], want) and not padded[:, len(xs):].any()
    assert torch.equal(K.pack_bytes(b"", mont, lanes=3), torch.zeros((8, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.pack_bytes(bytes(33), mont)


def test_scalars_to_limbs_and_windows_match_jax():
    xs = _vals(C.R, 5)
    np.testing.assert_array_equal(msm.scalars_to_limbs(xs, C.R, "cpu").numpy(),
                                  jax_to_port(np.asarray(jmsm.scalars_to_limbs(xs, C.R))))
    np.testing.assert_array_equal(msm.scalars_to_windows(xs, C.R, "cpu").numpy(),
                                  np.asarray(jmsm.scalars_to_windows(xs, C.R)))


def _systems():
    """(port, JAX) pairs: the multiplication chain, and a DSL circuit whose
    rows have negative coefficients."""
    pairs = [(mul_chain_r1cs(40, seed=5), jax_mul_chain_r1cs(40, seed=5))]
    pc, jc = pcc.parse_source(OPS_SOURCE), jcc.parse_source(OPS_SOURCE)
    pc.calculate_witness(*OPS_INPUTS, field_modulus=C.R)
    jc.calculate_witness(*OPS_INPUTS, field_modulus=C.R)
    pairs.append((SparseR1CS.from_circuit(pc), JaxSparseR1CS.from_circuit(jc)))
    assert any(v > C.R // 2 for row in pairs[1][0].A for v in row.values())
    return pairs


@pytest.mark.parametrize("which", [0, 1], ids=["mul_chain", "dsl_negative_coeffs"])
def test_row_evals_bytes(monkeypatch, which):
    port, jax_sys = _systems()[which]
    a, b, c, w = port._row_evals_bytes()
    evals = port.row_evals()
    assert tuple(native.ints_from_bytes(x) for x in (a, b, c)) == evals == tuple(jax_sys.row_evals())
    assert w == native.ints_to_bytes(port.witness, C.R)
    monkeypatch.setattr(native, "available", lambda: False)
    assert port._row_evals_bytes() == (a, b, c, w)


def test_prove_inputs_are_the_python_route(monkeypatch):
    """The prover's input tensors, through the bytes route (the library's
    where it is built, then without it) and through Python ints, at 30
    constraints; the key's sizes are all ``_prove_inputs`` reads."""
    fast = FastGroth16(device="cpu")
    r1cs = mul_chain_r1cs(30, seed=1)
    n, m, lo = _next_pow2(r1cs.n_constraints), r1cs.n_signals, r1cs.n_public + 1
    dpk = DevicePk(n=n, m=m, lo=lo, m_pad=fast._pad_for(m), mp_pad=fast._pad_for(m - lo), n_pad=fast._pad_for(n))
    w = [x % C.R for x in r1cs.witness]
    want_w = torch.from_numpy(ints_to_limbs_np(w + [0] * (dpk.m_pad - m)))
    want_wp = torch.from_numpy(ints_to_limbs_np(w[lo:] + [0] * (dpk.mp_pad - (m - lo))))
    want_h = [torch.from_numpy(fast.Kr.pack_python(v + [0] * (n - len(v)))) for v in r1cs.row_evals()]
    for library in (True, False):
        if not library:
            monkeypatch.setattr(native, "available", lambda: False)
        w_limbs, wp_limbs, h_in = fast._prove_inputs(r1cs, dpk)
        assert torch.equal(w_limbs, want_w) and torch.equal(wp_limbs, want_wp)
        assert len(h_in) == 3 and all(torch.equal(x, y) for x, y in zip(h_in, want_h))
