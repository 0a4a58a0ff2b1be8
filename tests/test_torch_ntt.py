"""The port's NTT kernels (plain versions of K3 and of K4's two forms) and
``NTTEngine`` held against the JAX package's ``NTTEngine``, bit for bit, at
<= 2^10 lanes; the port's four-step path against the plain radix-2 stage
loop at 2^14.
"""

import jax
import numpy as np
import pytest
import torch

from go_snark_study_tpu.ops.fields import fr_kernels as jax_fr_kernels
from go_snark_study_tpu.ops.ntt import NTTEngine as JaxNTTEngine
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.interop import jax_to_port, port_to_jax
from go_snark_study_tpu_torch.ops import ntt_kernels as nk
from go_snark_study_tpu_torch.ops.limbs import FieldKernels
from go_snark_study_tpu_torch.ops.ntt import NTTEngine

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)


def _rand_fr(seed, n):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % C.R for row in words]


@pytest.fixture(scope="module")
def engines():
    return JaxNTTEngine(jax_fr_kernels()), NTTEngine(FieldKernels(C.R, "cpu"))


@pytest.mark.parametrize("g", [2, 4, 8, 16])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_plain_small_ntt_matches_jax_col_transform(engines, g, inverse):
    jntt, ntt = engines
    b_lanes = 64
    vals = _rand_fr(g, g * b_lanes)
    x = ntt.K.pack(vals).reshape(8, g, b_lanes)
    want = jax.jit(lambda v: jntt._col_transform(v, g, inverse))(
        jax.numpy.asarray(port_to_jax(x))
    )
    got = nk.small_ntt(x.contiguous(), ntt.small_table(g, inverse))
    np.testing.assert_array_equal(port_to_jax(got), np.asarray(want))


COL_CASES = [(n_len, inverse) for n_len in (128, 256) for inverse in (False, True)]


@pytest.fixture(scope="module")
def col_fused_cases(engines):
    """Inputs (8, n_len, 8) and the JAX engine's ``_col_transform`` of each,
    all four cases under one jit (its XLA compile is the cost)."""
    jntt, ntt = engines
    xs = {n_len: ntt.K.pack(_rand_fr(n_len, n_len * 8)).reshape(8, n_len, 8) for n_len, _ in COL_CASES}
    args = {n_len: jax.numpy.asarray(port_to_jax(x)) for n_len, x in xs.items()}
    want = jax.jit(lambda a: [jntt._col_transform(a[n], n, inv) for n, inv in COL_CASES])(args)
    return {case: (xs[case[0]], np.asarray(w)) for case, w in zip(COL_CASES, want)}


@pytest.mark.parametrize("n_len, inverse", COL_CASES, ids=[f"{n}-{'inv' if i else 'fwd'}" for n, i in COL_CASES])
def test_col_fused_matches_jax_col_transform(engines, col_fused_cases, n_len, inverse):
    """The recursive radix-16 column transform (K3 leaves at g = 16 and 8 or
    16, the inner twiddle product and transpose) over 8 lanes."""
    _, ntt = engines
    x, want = col_fused_cases[n_len, inverse]
    np.testing.assert_array_equal(port_to_jax(ntt._col_fused(x, n_len, inverse)), want)


def test_plain_butterfly_matches_jax(engines):
    jntt, ntt = engines
    e, o, t = (ntt.K.pack(_rand_fr(s, 512)) for s in (1, 2, 3))
    jlo, jhi = jax.jit(jntt._butterfly)(*(jax.numpy.asarray(port_to_jax(v)) for v in (e, o, t)))
    lo, hi = nk.butterfly(e, o, t)
    np.testing.assert_array_equal(port_to_jax(lo), np.asarray(jlo))
    np.testing.assert_array_equal(port_to_jax(hi), np.asarray(jhi))


RADIX2_CASES = [(n, rows, inverse) for n, rows in ((2, 5), (16, 4), (256, 3), (1024, 1))
                for inverse in (False, True)]


@pytest.fixture(scope="module")
def radix2_cases(engines):
    """Inputs (8, rows*n) and the JAX engine's row-batched
    ``_transform_batched`` of each, all eight cases under one jit."""
    jntt, ntt = engines
    xs = {(n, rows): ntt.K.pack(_rand_fr(n + rows, n * rows)) for n, rows, _ in RADIX2_CASES}
    args = {f"{n}x{rows}": jax.numpy.asarray(port_to_jax(x)) for (n, rows), x in xs.items()}
    want = jax.jit(lambda a: [jntt._transform_batched(a[f"{n}x{rows}"], n, rows, inv)
                              for n, rows, inv in RADIX2_CASES])(args)
    return {case: (xs[case[:2]], np.asarray(w)) for case, w in zip(RADIX2_CASES, want)}


@pytest.mark.parametrize("n, rows, inverse", RADIX2_CASES,
                         ids=[f"{n}x{r}-{'inv' if i else 'fwd'}" for n, r, i in RADIX2_CASES])
def test_radix2_ntt_matches_jax_transform_batched(engines, radix2_cases, n, rows, inverse):
    """K4's whole-transform form (its plain version on the CPU), row-batched."""
    _, ntt = engines
    x, want = radix2_cases[n, rows, inverse]
    got = nk.radix2_ntt(x, ntt.master(n, inverse), length=n)
    np.testing.assert_array_equal(port_to_jax(got), want)


def _zeros(*shape, device="cpu"):
    return torch.zeros(shape, dtype=torch.int32, device=device)


@pytest.mark.parametrize("x, T, length", [
    (_zeros(8, 12), _zeros(8, 6), None),  # n not a power of two
    (_zeros(8, 1 << 14), _zeros(8, 1 << 13), None),  # n above 2^13
    (_zeros(8, 64), _zeros(8, 16), 16),  # table of 16 entries for n = 16
    (_zeros(8, 16), _zeros(8, 8, device="meta"), None),  # mixed devices
], ids=["not-pow2", "above-2^13", "table-length", "mixed-devices"])
def test_radix2_ntt_checks_its_arguments(x, T, length):
    with pytest.raises(ValueError):
        nk.radix2_ntt(x, T, length)


def test_radix2_transform_matches_jax_at_2_10(engines):
    jntt, ntt = engines
    vals = _rand_fr(4, 1 << 10)
    jx = jntt.K.pack(vals)
    x = torch.from_numpy(jax_to_port(np.asarray(jx)))
    fwd = ntt.forward(x)
    np.testing.assert_array_equal(port_to_jax(fwd), np.asarray(jntt.forward(jx)))
    inv = ntt.inverse(x)
    np.testing.assert_array_equal(port_to_jax(inv), np.asarray(jntt.inverse(jx)))
    assert torch.equal(ntt.inverse(fwd), x)


def test_fourstep_matches_radix2_at_2_14(engines):
    _, ntt = engines
    n = 1 << 14
    x = ntt.K.pack(_rand_fr(5, n))
    for inverse in (False, True):
        four = ntt._transform_fourstep(x, ntt.table(n, inverse), inverse)
        radix2 = nk.radix2_ntt_plain(x, ntt.master(n, inverse))
        assert torch.equal(four, radix2), inverse
    assert torch.equal(ntt.inverse(ntt.forward(x)), x)


def test_coset_powers_match_host():
    K = FieldKernels(C.R, "cpu")
    ntt = NTTEngine(K)
    n, g = 64, 5
    assert K.unpack(ntt.coset_powers(n, g, False)) == [pow(g, i, C.R) for i in range(n)]
    assert K.unpack(ntt.coset_powers(n, g, True)) == [pow(g, -i, C.R) for i in range(n)]
