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

Layer map (the slices ported so far: the trace-commitment pipeline, the
STARK prover with its LogUp phase, and the RV32IM VM proof):
  vm/machine       VirtualMachine: keygen -> prove -> verify of an RV32IM
                   guest (preflight in C++ on the host, numpy tracegen)
  stark            keygen -> prove -> verify, codec (host orchestration)
  stark/quotient   constraint DAG -> bytecode -> interpreter (K7+K11), and
                   its columns mode over the trace (K7)
  stark/logup      LogUp permutation trace (K9, K10)
  stark/lookup     lookup-multiplicity histograms (K8)
  stark/prover     openings (K12) and reduced openings (K13)
  fri              FRI fold (K14), query gathers, host verification
  field/babybear   BabyBear Montgomery arithmetic (kernel K1)
  field/ext        quartic extension arithmetic (K2)
  ntt              coset LDE (K3)
  poseidon2        Poseidon2 permutation and row sponge (K4)
  merkle           mixed-height Merkle commitment (K5), query gathers (K6),
                   host verification
  challenger       Fiat-Shamir duplex challenger (host)
"""

__version__ = "0.1.0"
