"""Shape-by-shape JSON codecs for every protocol artifact.

Copy of ``go_snark_study_tpu/utils/serializers.py``, over the port's
``circuitcompiler``, ``models.groth16`` and ``models.pinocchio``.

Reference: utils/base10parsers.go + utils/hexparsers.go — these define the
WIRE FORMAT (field names and nesting are the Go struct layouts marshaled by
encoding/json), which this module reproduces exactly so artifacts round-trip
against the reference and against snarkjs (externalVerif).

One generic implementation parametrised by radix; ``base10`` and ``hexcodec``
expose the two concrete dialects (Go emits decimal via big.Int.String and
lowercase hex via big.Int.Text(16); both parse with SetString in that base).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from ..circuitcompiler import Circuit, Constraint
from ..circuitcompiler.circuit import R1CS
from ..models import groth16 as g16, pinocchio as pgh
from .validate import check_g1, check_g2, check_g2_subgroup

__all__ = ["Codec"]


class Codec:
    """base 10 / base 16 string dialects, plus base 0 = "raw": numbers kept
    as JSON numbers, matching Go's json.Marshal of *big.Int — the format the
    reference CLI persists to compiledcircuit.json / trustedsetup.json /
    proofs.json (the *String variants are only written under the ``wasm``
    flag, cli/main.go:194-226)."""

    def __init__(self, base: int):
        assert base in (0, 10, 16)
        self.base = base

    # -- scalar <-> string/number -----------------------------------------
    def s(self, x: int):
        if x is None:
            return None  # mirrors Go's nil *big.Int -> null
        if self.base == 0:
            return int(x)
        if self.base == 10:
            return str(x)
        return ("-" if x < 0 else "") + format(abs(x), "x")

    def i(self, s) -> int:
        if self.base == 0:
            return int(s)
        return int(s, self.base)

    # -- shaped helpers (mirroring base10parsers.go:13-130) ---------------
    def arr(self, xs: Sequence[int]) -> List[str]:
        return [self.s(x) for x in xs]

    def arr_i(self, ss: Sequence[str]) -> List[int]:
        return [self.i(x) for x in ss]

    def p3(self, p) -> List[str]:  # [3] G1 Jacobian point
        return [self.s(p[0]), self.s(p[1]), self.s(p[2])]

    def p3_i(self, ss):
        # on-curve validation at the wire boundary (deliberate divergence
        # from the reference's raw tuples — see utils/validate.py)
        return check_g1((self.i(ss[0]), self.i(ss[1]), self.i(ss[2])))

    def p32(self, p) -> List[List[str]]:  # [3][2] G2 Jacobian point
        return [[self.s(c[0]), self.s(c[1])] for c in p]

    def p32_i(self, ss, subgroup: bool = False):
        p = tuple((self.i(c[0]), self.i(c[1])) for c in ss)
        return check_g2_subgroup(p) if subgroup else check_g2(p)

    def arr_p3(self, ps) -> List[List[str]]:
        return [self.p3(p) for p in ps]

    def arr_p3_i(self, ss):
        return [self.p3_i(p) for p in ss or []]

    def arr_p32(self, ps):
        return [self.p32(p) for p in ps]

    def arr_p32_i(self, ss):
        return [self.p32_i(p) for p in ss or []]

    def mat(self, m) -> List[List[str]]:
        return [self.arr(row) for row in m]

    def mat_i(self, ss):
        return [self.arr_i(row) for row in ss or []]

    # ------------------------------------------------------------------
    # Pinocchio Setup (SetupString, base10parsers.go:135-256)
    # ------------------------------------------------------------------
    def setup_to_dict(self, setup: pgh.Setup) -> Dict[str, Any]:
        pk, vk = setup.pk, setup.vk
        return {
            "Pk": {
                "G1T": self.arr_p3(pk.g1t),
                "A": self.arr_p3(pk.a),
                "B": self.arr_p32(pk.b),
                "C": self.arr_p3(pk.c),
                "Kp": self.arr_p3(pk.kp),
                "Ap": self.arr_p3(pk.ap),
                "Bp": self.arr_p3(pk.bp),
                "Cp": self.arr_p3(pk.cp),
                "Z": self.arr(pk.z),
            },
            "Vk": {
                "Vka": self.p32(vk.vka),
                "Vkb": self.p3(vk.vkb),
                "Vkc": self.p32(vk.vkc),
                "IC": self.arr_p3(vk.ic),
                "G1Kbg": self.p3(vk.g1_kbg),
                "G2Kbg": self.p32(vk.g2_kbg),
                "G2Kg": self.p32(vk.g2_kg),
                "Vkz": self.p32(vk.vkz),
            },
        }

    def setup_from_dict(self, d: Dict[str, Any]) -> pgh.Setup:
        pk_d, vk_d = d["Pk"], d["Vk"]
        pk = pgh.Pk(
            g1t=self.arr_p3_i(pk_d["G1T"]),
            a=self.arr_p3_i(pk_d["A"]),
            b=self.arr_p32_i(pk_d["B"]),
            c=self.arr_p3_i(pk_d["C"]),
            kp=self.arr_p3_i(pk_d["Kp"]),
            ap=self.arr_p3_i(pk_d["Ap"]),
            bp=self.arr_p3_i(pk_d["Bp"]),
            cp=self.arr_p3_i(pk_d["Cp"]),
            z=self.arr_i(pk_d["Z"]),
        )
        vk = pgh.Vk(
            vka=self.p32_i(vk_d["Vka"], subgroup=True),
            vkb=self.p3_i(vk_d["Vkb"]),
            vkc=self.p32_i(vk_d["Vkc"], subgroup=True),
            ic=self.arr_p3_i(vk_d["IC"]),
            g1_kbg=self.p3_i(vk_d["G1Kbg"]),
            g2_kbg=self.p32_i(vk_d["G2Kbg"], subgroup=True),
            g2_kg=self.p32_i(vk_d["G2Kg"], subgroup=True),
            vkz=self.p32_i(vk_d["Vkz"], subgroup=True),
        )
        return pgh.Setup(pk=pk, vk=vk)

    # ------------------------------------------------------------------
    # Circuit (CircuitString, base10parsers.go:259-335)
    # ------------------------------------------------------------------
    def circuit_to_dict(self, c: Circuit) -> Dict[str, Any]:
        return {
            "NVars": c.n_vars,
            "NPublic": c.n_public,
            "NSignals": c.n_signals,
            "PrivateInputs": c.private_inputs,
            "PublicInputs": c.public_inputs,
            "Signals": c.signals,
            "Witness": self.arr(c.witness),
            "Constraints": [k.to_json() for k in c.constraints],
            "R1CS": {
                "A": self.mat(c.r1cs.A),
                "B": self.mat(c.r1cs.B),
                "C": self.mat(c.r1cs.C),
            },
        }

    def circuit_from_dict(self, d: Dict[str, Any]) -> Circuit:
        c = Circuit(
            n_vars=d.get("NVars", 0),
            n_public=d.get("NPublic", 0),
            n_signals=d.get("NSignals", 0),
            private_inputs=list(d.get("PrivateInputs") or []),
            public_inputs=list(d.get("PublicInputs") or []),
            signals=list(d.get("Signals") or []),
            witness=self.arr_i(d.get("Witness") or []),
            constraints=[Constraint.from_json(k) for k in d.get("Constraints") or []],
        )
        r = d.get("R1CS") or {}
        c.r1cs = R1CS(
            A=self.mat_i(r.get("A")), B=self.mat_i(r.get("B")), C=self.mat_i(r.get("C"))
        )
        return c

    # ------------------------------------------------------------------
    # Pinocchio Proof (ProofString, base10parsers.go:338-398)
    # ------------------------------------------------------------------
    def proof_to_dict(self, p: pgh.Proof) -> Dict[str, Any]:
        return {
            "PiA": self.p3(p.pi_a),
            "PiAp": self.p3(p.pi_ap),
            "PiB": self.p32(p.pi_b),
            "PiBp": self.p3(p.pi_bp),
            "PiC": self.p3(p.pi_c),
            "PiCp": self.p3(p.pi_cp),
            "PiH": self.p3(p.pi_h),
            "PiKp": self.p3(p.pi_kp),
        }

    def proof_from_dict(self, d: Dict[str, Any]) -> pgh.Proof:
        return pgh.Proof(
            pi_a=self.p3_i(d["PiA"]),
            pi_ap=self.p3_i(d["PiAp"]),
            pi_b=self.p32_i(d["PiB"], subgroup=True),
            pi_bp=self.p3_i(d["PiBp"]),
            pi_c=self.p3_i(d["PiC"]),
            pi_cp=self.p3_i(d["PiCp"]),
            pi_h=self.p3_i(d["PiH"]),
            pi_kp=self.p3_i(d["PiKp"]),
        )

    # ------------------------------------------------------------------
    # Groth16 (GrothSetupString / GrothVkString / GrothProofString,
    # base10parsers.go:401-585)
    # ------------------------------------------------------------------
    def groth_setup_to_dict(self, setup: g16.Setup) -> Dict[str, Any]:
        pk, vk = setup.pk, setup.vk
        return {
            "Pk": {
                "BACDelta": self.arr_p3(pk.bacdelta),
                "Z": self.arr(pk.z),
                "G1": {
                    "Alpha": self.p3(pk.g1.alpha),
                    "Beta": self.p3(pk.g1.beta),
                    "Delta": self.p3(pk.g1.delta),
                    "At": self.arr_p3(pk.g1.at),
                    "BACGamma": self.arr_p3(pk.g1.bacgamma),
                },
                "G2": {
                    # NOTE: the reference never sets Pk.G2.Gamma (its string
                    # round-trip of this field is broken — "<nil>" values);
                    # we set it to g2*Kgamma in setup and tolerate
                    # nil/"<nil>" when parsing reference artifacts.
                    "Beta": self.p32(pk.g2.beta),
                    "Gamma": self.p32(pk.g2.gamma)
                    if pk.g2.gamma
                    else [[None, None]] * 3,
                    "Delta": self.p32(pk.g2.delta),
                    "BACGamma": self.arr_p32(pk.g2.bacgamma),
                },
                "PowersTauDelta": self.arr_p3(pk.powers_tau_delta),
            },
            "Vk": self.groth_vk_to_dict(vk),
        }

    def groth_vk_to_dict(self, vk: g16.Vk) -> Dict[str, Any]:
        return {
            "IC": self.arr_p3(vk.ic),
            "G1": {"Alpha": self.p3(vk.g1.alpha)},
            "G2": {
                "Beta": self.p32(vk.g2.beta),
                "Gamma": self.p32(vk.g2.gamma),
                "Delta": self.p32(vk.g2.delta),
            },
        }

    def groth_vk_from_dict(self, d: Dict[str, Any]) -> g16.Vk:
        vk = g16.Vk()
        vk.ic = self.arr_p3_i(d["IC"])
        vk.g1.alpha = self.p3_i(d["G1"]["Alpha"])
        vk.g2.beta = self.p32_i(d["G2"]["Beta"], subgroup=True)
        vk.g2.gamma = self.p32_i(d["G2"]["Gamma"], subgroup=True)
        vk.g2.delta = self.p32_i(d["G2"]["Delta"], subgroup=True)
        return vk

    def groth_setup_from_dict(self, d: Dict[str, Any]) -> g16.Setup:
        pk_d = d["Pk"]
        pk = g16.Pk(
            bacdelta=self.arr_p3_i(pk_d["BACDelta"]),
            z=self.arr_i(pk_d["Z"]),
            powers_tau_delta=self.arr_p3_i(pk_d["PowersTauDelta"]),
        )
        pk.g1.alpha = self.p3_i(pk_d["G1"]["Alpha"])
        pk.g1.beta = self.p3_i(pk_d["G1"]["Beta"])
        pk.g1.delta = self.p3_i(pk_d["G1"]["Delta"])
        pk.g1.at = self.arr_p3_i(pk_d["G1"]["At"])
        pk.g1.bacgamma = self.arr_p3_i(pk_d["G1"]["BACGamma"])
        pk.g2.beta = self.p32_i(pk_d["G2"]["Beta"])
        try:
            pk.g2.gamma = self.p32_i(pk_d["G2"]["Gamma"])
        except (TypeError, ValueError):
            pk.g2.gamma = None  # reference artifacts carry nil/"<nil>" here
        pk.g2.delta = self.p32_i(pk_d["G2"]["Delta"])
        pk.g2.bacgamma = self.arr_p32_i(pk_d["G2"]["BACGamma"])
        return g16.Setup(pk=pk, vk=self.groth_vk_from_dict(d["Vk"]))

    def groth_proof_to_dict(self, p: g16.Proof) -> Dict[str, Any]:
        return {"PiA": self.p3(p.pi_a), "PiB": self.p32(p.pi_b), "PiC": self.p3(p.pi_c)}

    def groth_proof_from_dict(self, d: Dict[str, Any]) -> g16.Proof:
        # πB gets the full subgroup check: it is the only proof element the
        # verifier pairs from G2, where on-curve alone does not pin the
        # r-torsion (cofactor != 1 on the twist)
        return g16.Proof(
            pi_a=self.p3_i(d["PiA"]),
            pi_b=self.p32_i(d["PiB"], subgroup=True),
            pi_c=self.p3_i(d["PiC"]),
        )
