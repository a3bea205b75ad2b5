"""Pairing extension: BN254 / BLS12-381 optimal-Ate pairing check.

Copy of openvm_tpu/pairing/__init__.py, with the same exports.  Host-side
counterpart of the reference `extensions/pairing` + pairing guest lib
(`guest-libs/pairing`): Miller loop, residue-witness final-exp hints, and
the HintFinalExp phantom used by guests to verify pairings in-circuit
with Fp/Fp2 intrinsics only.
"""

from .curve import BLS12_381, BN254, CURVES, PairingCurveParams
from .final_exp import assert_final_exp_is_one, final_exp_hint, pairing_check
from .miller import multi_miller_loop
from .tower import Tower

__all__ = [
    "BLS12_381", "BN254", "CURVES", "PairingCurveParams", "Tower",
    "assert_final_exp_is_one", "final_exp_hint", "multi_miller_loop",
    "pairing_check",
]
