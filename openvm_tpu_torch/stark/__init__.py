"""Multi-trace STARK proof system: so far its configuration."""

from .config import FriParameters, StarkConfig, baby_bear_poseidon2_config

__all__ = ["FriParameters", "StarkConfig", "baby_bear_poseidon2_config"]
