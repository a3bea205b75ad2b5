"""Multi-trace STARK proof system (BabyBear + FRI) on the card.

The same exports as openvm_tpu.stark.  ``keygen(airs, config, device=None)``
and ``prove(pk, ctxs, device=None)`` place their tensors on CUDA unless the
caller names another device; ``verify`` and the codec are host code.  AIRs
with interactions get the LogUp phase (``logup``, kernels K9 and K10).
"""

from .config import FriParameters, StarkConfig, baby_bear_poseidon2_config
from .keygen import keygen, MultiStarkProvingKey, MultiStarkVerifyingKey
from .prover import AirProvingContext, Proof, prove
from .symbolic import Air, AirBuilder
from .verifier import VerificationError, verify

__all__ = [
    "Air", "AirBuilder", "AirProvingContext", "FriParameters", "Proof",
    "StarkConfig", "VerificationError", "baby_bear_poseidon2_config",
    "keygen", "prove", "verify", "MultiStarkProvingKey",
    "MultiStarkVerifyingKey",
]
