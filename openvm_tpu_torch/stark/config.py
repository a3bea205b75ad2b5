"""STARK configuration: FRI parameters and global proof-system knobs.

Copy of openvm_tpu/stark/config.py:1-50, which mirrors the reference's
``FriParameters`` surface (reference crates/sdk/src/config/mod.rs:130-141).
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_TWO_ADICITY = 27  # BabyBear


@dataclass(frozen=True)
class FriParameters:
    log_blowup: int = 1
    log_final_poly_len: int = 0  # reference verifier requires 0
    num_queries: int = 100
    proof_of_work_bits: int = 16

    @staticmethod
    def standard_with_100_bits_conjectured_security(log_blowup: int
                                                    ) -> "FriParameters":
        """Queries so that log_blowup * num_queries + pow_bits >= 100."""
        pow_bits = 16
        num_queries = -(-(100 - pow_bits) // log_blowup)
        return FriParameters(log_blowup=log_blowup, num_queries=num_queries,
                             proof_of_work_bits=pow_bits)

    @staticmethod
    def new_for_testing(log_blowup: int = 1) -> "FriParameters":
        return FriParameters(log_blowup=log_blowup, num_queries=2,
                             proof_of_work_bits=1)

    @property
    def max_log_trace_height(self) -> int:
        return MAX_TWO_ADICITY - self.log_blowup


@dataclass(frozen=True)
class StarkConfig:
    fri: FriParameters = FriParameters()
    # LogUp proof-of-work grinding before sampling challenges
    log_up_pow_bits: int = 0
    # bound on per-AIR constraint degree (drives quotient degree + chunking)
    max_constraint_degree: int = 3


def baby_bear_poseidon2_config(fri: FriParameters | None = None) -> StarkConfig:
    return StarkConfig(fri=fri or FriParameters())
