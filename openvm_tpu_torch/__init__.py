"""openvm_tpu_torch: the openvm_tpu prover ported to PyTorch and CUDA.

The JAX package ``openvm_tpu`` is the reference; this package computes the
same raw Montgomery words, digests and roots with hand-written CUDA kernels
for Hopper (``csrc/``, built with nvcc at first use by ``_build``).  It
imports neither JAX nor ``openvm_tpu``.

Where things run: a function that takes tensors runs on their device; a
constructor (``field.babybear.from_numpy`` and the like) defaults to CUDA and
raises when there is none.  The CPU is used only when the caller passes
``device="cpu"``, and then every kernel wrapper runs its plain PyTorch
version.  A wrapper given a CUDA tensor launches its kernel or raises.

Layer map (the slice ported so far, the trace-commitment pipeline):
  field/babybear   BabyBear Montgomery arithmetic (kernel K1)
  ntt              coset LDE (K3)
  poseidon2        Poseidon2 permutation and row sponge (K4)
  merkle           mixed-height Merkle commitment (K5), host verification
  challenger       Fiat-Shamir duplex challenger (host)
  stark/config     FRI parameters
"""

__version__ = "0.1.0"
