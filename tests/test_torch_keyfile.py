"""The port's binary key file (``utils/keyfile.py``) against the JAX
package's, and ``FastGroth16.setup(materialize_host=False)``.

Both packages write the same ``gosnark-fast-setup-v1`` NPZ, so a key
written by either loads in the other, bit for bit.  The JAX side is built
from the committed record ``testdata/groth16_mul_chain30.npz`` (its device
key leaves made with ``jnp.asarray``): no JAX setup or prove runs here, so
nothing compiles.  The port runs one setup, on the CPU.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "go_snark_study_tpu_torch", "testdata", "groth16_mul_chain30.npz",
)
KEY_FIELDS = ("at", "b1", "b2", "cdelta", "ptau")


def _g1(p):
    return tuple(int(c) for c in p)


def _g2(p):
    return tuple((int(c[0]), int(c[1])) for c in p)


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    return json.loads(str(z["meta"])), {k: z[k].astype(np.int32) for k in KEY_FIELDS}


@pytest.fixture(scope="module")
def port_setup():
    """The port's setup at the record's inputs, without host lists."""
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    fast = FastGroth16(device="cpu")
    return fast.setup(mul_chain_r1cs(30, seed=1), rng=random.Random(42), materialize_host=False)


def _leaves(dpk):
    """{member name: port tensor} of a port DevicePk, named as in the file."""
    out = {}
    for f in KEY_FIELDS:
        for ci, coord in enumerate(getattr(dpk, f)):
            if f == "b2":
                for k, comp in enumerate(coord):
                    out[f"{f}.{ci}.{k}"] = comp
            else:
                out[f"{f}.{ci}"] = coord
    return out


def _jax_setup(meta, arrays):
    """A JAX ``groth16.Setup`` holding the record's vk, host points and
    device key (``jnp.asarray`` leaves: no compile)."""
    import jax.numpy as jnp

    from go_snark_study_tpu.models import groth16 as jg16
    from go_snark_study_tpu.models.groth16_fast import DevicePk

    setup = jg16.Setup()
    vk, pk = meta["vk"], meta["pk"]
    setup.vk.g1.alpha = _g1(vk["alpha"])
    setup.vk.g2.beta, setup.vk.g2.gamma, setup.vk.g2.delta = _g2(vk["beta"]), _g2(vk["gamma"]), _g2(vk["delta"])
    setup.vk.ic = [_g1(p) for p in vk["ic"]]
    setup.pk.g1.alpha, setup.pk.g1.beta, setup.pk.g1.delta = (_g1(pk[k]) for k in ("g1_alpha", "g1_beta", "g1_delta"))
    setup.pk.g2.beta, setup.pk.g2.gamma, setup.pk.g2.delta = _g2(pk["g2_beta"]), _g2(vk["gamma"]), _g2(pk["g2_delta"])
    g1 = lambda a: tuple(jnp.asarray(a[i]) for i in range(3))
    g2 = lambda a: tuple(tuple(jnp.asarray(a[i, k]) for k in range(2)) for i in range(3))
    setup.pk._device = DevicePk(
        n=meta["n"], m=meta["m"], lo=meta["lo"],
        m_pad=arrays["at"].shape[-1], mp_pad=arrays["cdelta"].shape[-1], n_pad=arrays["ptau"].shape[-1],
        **{k: (g2 if k == "b2" else g1)(arrays[k]) for k in KEY_FIELDS},
    )
    return setup


def _same_header(got, want):
    assert got.vk.g1.alpha == want.vk.g1.alpha and got.vk.ic == want.vk.ic
    assert (got.vk.g2.beta, got.vk.g2.gamma, got.vk.g2.delta) == (want.vk.g2.beta, want.vk.g2.gamma, want.vk.g2.delta)
    for grp, names in (("g1", ("alpha", "beta", "delta")), ("g2", ("beta", "gamma", "delta"))):
        for name in names:
            assert getattr(getattr(got.pk, grp), name) == getattr(getattr(want.pk, grp), name), (grp, name)


def test_setup_without_host_lists_gives_the_golden_key(golden, port_setup):
    """``materialize_host=False`` gives the record's vk and device key and
    leaves the host lists empty."""
    from go_snark_study_tpu_torch.bn128 import default_bn128
    from go_snark_study_tpu_torch.interop import port_to_jax

    meta, arrays = golden
    bn = default_bn128()
    vk = meta["vk"]
    assert bn.g1.equal(port_setup.vk.g1.alpha, _g1(vk["alpha"]))
    for name in ("beta", "gamma", "delta"):
        assert bn.g2.equal(getattr(port_setup.vk.g2, name), _g2(vk[name]))
    assert len(port_setup.vk.ic) == len(vk["ic"])
    assert all(bn.g1.equal(a, _g1(b)) for a, b in zip(port_setup.vk.ic, vk["ic"]))
    dpk = port_setup.pk._device
    for k in KEY_FIELDS:
        pt = getattr(dpk, k)
        if k == "b2":
            got = np.stack([np.stack([port_to_jax(c) for c in co]) for co in pt])
        else:
            got = np.stack([port_to_jax(c) for c in pt])
        np.testing.assert_array_equal(got, arrays[k], err_msg=k)
    pk = port_setup.pk
    assert pk.g1.at == [] and pk.powers_tau_delta == []
    assert pk.g1.bacgamma == [] and pk.g2.bacgamma == [] and pk.bacdelta == []


def test_jax_written_key_loads_in_the_port(tmp_path, golden):
    """JAX's ``save_fast_setup`` of the record -> the port's
    ``load_fast_setup``: the device key equals ``device_pk_from_jax`` of
    the record bit for bit, and the header points are equal."""
    from go_snark_study_tpu.utils import keyfile as jax_keyfile
    from go_snark_study_tpu_torch.interop import device_pk_from_jax
    from go_snark_study_tpu_torch.utils import keyfile

    meta, arrays = golden
    jsetup = _jax_setup(meta, arrays)
    path = str(tmp_path / keyfile.KEYFILE)
    jax_keyfile.save_fast_setup(path, jsetup)
    got = keyfile.load_fast_setup(path, device="cpu")
    want = device_pk_from_jax(arrays, n=meta["n"], m=meta["m"], lo=meta["lo"], device="cpu")
    dpk = got.pk._device
    for f in ("n", "m", "lo", "m_pad", "mp_pad", "n_pad"):
        assert getattr(dpk, f) == getattr(want, f), f
    gl, wl = _leaves(dpk), _leaves(want)
    assert gl.keys() == wl.keys()
    for name in gl:
        assert gl[name].device.type == "cpu" and gl[name].dtype == torch.int32
        assert torch.equal(gl[name], wl[name]), name
    _same_header(got, jsetup)
    n = meta["n"]
    assert got.pk.z == [got.pk.z[0]] + [0] * (n - 1) + [1] and got.pk.g1.at == []


def test_port_written_key_loads_in_jax(tmp_path, port_setup):
    """The port's ``save_fast_setup`` -> JAX's ``load_fast_setup``: every
    leaf equals ``port_to_jax`` of the port's tensor."""
    from go_snark_study_tpu.utils import keyfile as jax_keyfile
    from go_snark_study_tpu_torch.interop import port_to_jax
    from go_snark_study_tpu_torch.utils import keyfile

    path = str(tmp_path / keyfile.KEYFILE)
    keyfile.save_fast_setup(path, port_setup.strip_toxic())
    jsetup = jax_keyfile.load_fast_setup(path)
    jd, pd = jsetup.pk._device, port_setup.pk._device
    for f in ("n", "m", "lo", "m_pad", "mp_pad", "n_pad"):
        assert getattr(jd, f) == getattr(pd, f), f
    for f in KEY_FIELDS:
        for ci in range(3):
            if f == "b2":
                for k in range(2):
                    got = np.asarray(jd.b2[ci][k])
                    np.testing.assert_array_equal(got, port_to_jax(pd.b2[ci][k]), err_msg=f"b2.{ci}.{k}")
                    assert got.dtype == np.int32
            else:
                np.testing.assert_array_equal(
                    np.asarray(getattr(jd, f)[ci]), port_to_jax(getattr(pd, f)[ci]), err_msg=f"{f}.{ci}")
    _same_header(jsetup, port_setup)


def test_header_alone_needs_no_device_key(tmp_path, port_setup):
    from go_snark_study_tpu_torch.utils import keyfile

    path = str(tmp_path / keyfile.KEYFILE)
    keyfile.save_fast_setup(path, port_setup.strip_toxic())
    head = keyfile.load_fast_header(path)
    assert getattr(head.pk, "_device", None) is None
    _same_header(head, port_setup)


def test_keyfile_refuses_what_is_not_a_fast_key(tmp_path):
    from go_snark_study_tpu_torch.models.groth16 import Setup
    from go_snark_study_tpu_torch.utils import keyfile

    with pytest.raises(ValueError, match="no device proving key"):
        keyfile.save_fast_setup(str(tmp_path / "k.npz"), Setup())
    path = str(tmp_path / "other.npz")
    with open(path, "wb") as fh:
        np.savez(fh, header=np.frombuffer(json.dumps({"format": "other"}).encode(), dtype=np.uint8))
    with pytest.raises(ValueError, match="not a fast-setup keyfile"):
        keyfile.load_fast_setup(path, device="cpu")
