"""CPU timing of the plain Poseidon2 permutation's two general forms.

``poseidon2._permute64`` computes on a (..., 16) tensor, each operation
over all lanes at once; ``poseidon2._permute_lanes`` keeps each lane in a
contiguous tensor of its own (16 times the operations, each on a
contiguous column).  This script times both on one CPU thread at batch
sizes from 1 to 2^17 states, checks that they give the same values, and
prints the first's time over the second's: where it passes 1 is
``poseidon2.LANE_MAJOR_STATES``.  Run:

    python -m openvm_tpu_torch.plain_timing
"""

from __future__ import annotations

import time

import torch

from . import poseidon2 as p2

BATCHES = (1, 16, 64, 256, 1024, 2048, 4096, 8192, 16384, 1 << 17)


def _ms(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> None:
    torch.set_num_threads(1)
    consts = p2._plain_constants(p2._RC_VERSION, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    print("states  all_lanes_ms  lane_major_ms  ratio")
    for n in BATCHES:
        s = torch.randint(0, p2.P, (n, 16), generator=g, dtype=torch.int64)
        reps = max(3, 20_000 // n)
        # the (..., 16) form: structured_diag=False below the threshold
        saved, p2.LANE_MAJOR_STATES = p2.LANE_MAJOR_STATES, 1 << 62
        try:
            whole = _ms(lambda: p2._permute64(s, consts), reps)
            want = p2._permute64(s, consts)
        finally:
            p2.LANE_MAJOR_STATES = saved
        lanes = _ms(lambda: p2._permute_lanes(s, consts), reps)
        assert torch.equal(p2._permute_lanes(s, consts), want)
        print(f"{n:6d}  {whole:12.3f}  {lanes:13.3f}  {whole / lanes:.2f}")


if __name__ == "__main__":
    main()
