"""The PyTorch port's field layer (K2 and its plain version) held against
the JAX package's ``FieldKernels``, bit for bit; the port's import and
device rules; the kernel wrappers' argument checks.

Inputs come from numpy with a seed and cross between the packages as numpy
arrays.  On the CPU every wrapper runs its kernel's plain version; the
kernels themselves are held against those on the card in
``tests/test_torch_gpu.py``.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from go_snark_study_tpu.ops.limbs import FieldKernels as JaxFieldKernels
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.interop import jax_to_port, port_to_jax
from go_snark_study_tpu_torch.ops import mont_mul as mm
from go_snark_study_tpu_torch.ops.limbs import FieldKernels

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 256


def _vals(p, seed, n=LANES):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    return [0, 1, p - 1] + vals[3:]


@pytest.fixture(scope="module", params=[("fq", C.Q), ("fr", C.R)], ids=["fq", "fr"])
def fields(request):
    _, p = request.param
    return p, JaxFieldKernels(p), FieldKernels(p, "cpu")


def _same(port_t, jax_arr):
    np.testing.assert_array_equal(port_to_jax(port_t), np.asarray(jax_arr))


def test_mont_mul_matches_jax(fields):
    p, JK, K = fields
    a, b = _vals(p, 1), _vals(p, 2)
    ja, jb = JK.pack(a), JK.pack(b)
    # the JAX CIOS scan: bit-identical to its Pallas kernel
    want = jax.jit(JK._mul_xla)(ja, jb)
    got = K.mul(K.pack(a), K.pack(b))
    _same(got, want)
    # inputs converted from the JAX layout give the same bits
    _same(mm.mont_mul(torch.from_numpy(jax_to_port(np.asarray(ja))),
                      torch.from_numpy(jax_to_port(np.asarray(jb))), p), want)


def test_add_sub_neg_match_jax(fields):
    p, JK, K = fields
    a, b = _vals(p, 3), _vals(p, 4)
    ja, jb, ta, tb = JK.pack(a), JK.pack(b), K.pack(a), K.pack(b)
    _same(K.add(ta, tb), JK.add(ja, jb))
    _same(K.sub(ta, tb), JK.sub(ja, jb))
    _same(K.sub(tb, ta), JK.sub(jb, ja))
    _same(K.neg(ta), JK.neg(ja))
    _same(K.double(ta), JK.double(ja))


def test_mont_conversions_match_jax(fields):
    p, JK, K = fields
    a = _vals(p, 5)
    plain_j, plain_t = JK.pack(a, mont=False), K.pack(a, mont=False)
    _same(K.to_mont(plain_t), JK.to_mont(plain_j))
    mont_j, mont_t = JK.pack(a), K.pack(a)
    _same(K.from_mont(mont_t), JK.from_mont(mont_j))
    assert K.unpack(mont_t) == [x % p for x in a]


def test_batch_inverse_matches_jax(fields):
    p, JK, K = fields
    a = _vals(p, 6, n=48)  # a zero lane included: inverts to zero
    _same(K.batch_inverse(K.pack(a)), jax.jit(JK.batch_inverse)(JK.pack(a)))
    inv = K.unpack(K.batch_inverse(K.pack(a)))
    assert inv == [pow(x, -1, p) if x else 0 for x in a]


def test_header_constants_match_the_moduli():
    """csrc/field.cuh hard-codes both moduli and their CIOS constants."""
    src = open(os.path.join(REPO, "go_snark_study_tpu_torch", "csrc", "field.cuh")).read()
    for name, p in (("ModQ", C.Q), ("ModR", C.R)):
        body = src.split(f"struct {name}")[1].split("};")[0]
        limbs = [int(x, 16) for x in re.findall(r"return (0x[0-9a-f]+)u;", body)]
        assert limbs == [(p >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        n0 = int(re.search(r"n0 = (0x[0-9a-f]+)u;", body).group(1), 16)
        assert n0 == mm.n0_32(p)
    assert set(mm.FIELD_IDS) == {C.Q, C.R}


def test_import_loads_no_jax():
    """Importing the port (every module) pulls in neither jax nor any
    module of the JAX package."""
    code = (
        "import sys\n"
        "import go_snark_study_tpu_torch.interop, go_snark_study_tpu_torch.models.groth16_fast\n"
        "import go_snark_study_tpu_torch.ops.ntt, go_snark_study_tpu_torch.ops.fixed_base\n"
        "import go_snark_study_tpu_torch.api, go_snark_study_tpu_torch.models.accel\n"
        "import go_snark_study_tpu_torch.cli, go_snark_study_tpu_torch.utils.keyfile\n"
        "import go_snark_study_tpu_torch.embed, go_snark_study_tpu_torch.server\n"
        "import go_snark_study_tpu_torch.externalverif, go_snark_study_tpu_torch.r1csqap.float_qap\n"
        "import go_snark_study_tpu_torch.profiling, go_snark_study_tpu_torch.ops.fields\n"
        "import go_snark_study_tpu_torch.parallel.checks, go_snark_study_tpu_torch.parallel.scaling\n"
        "import go_snark_study_tpu_torch.parallel.sharded_prover, go_snark_study_tpu_torch.graft_entry\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'go_snark_study_tpu' or m.startswith('go_snark_study_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_without_a_card_raise(monkeypatch):
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastGroth16()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FieldKernels(C.Q)


def test_kernel_wrappers_check_their_arguments():
    from go_snark_study_tpu_torch.ops import ntt_kernels as nk
    from go_snark_study_tpu_torch.ops import point_add as pa

    a = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        mm.mont_mul(a.to(torch.int64), a, C.Q)
    with pytest.raises(ValueError, match="contiguous"):
        mm.mont_mul(torch.zeros((16, 8), dtype=torch.int32).T, a, C.Q)
    with pytest.raises(ValueError, match="shape"):
        mm.mont_mul(a, a[:, :8].contiguous(), C.Q)
    with pytest.raises(ValueError):
        nk.small_ntt(torch.zeros((8, 3, 4), dtype=torch.int32), torch.zeros((8, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        nk.butterfly(a, a, a[:, :4].contiguous())
    with pytest.raises(ValueError):
        pa.point_add("jadd", 1, (a, a, a), (a, a, a[:, :4].contiguous()))
