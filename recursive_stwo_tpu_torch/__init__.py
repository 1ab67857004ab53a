"""PyTorch + CUDA port of the batched PlonkWithPoseidon circle-STARK verifier.

The JAX package `recursive_stwo_tpu` is the reference; this package mirrors
its module names.  Field elements are `torch.int64` tensors holding canonical
M31 residues in [0, p).  The host-only (numpy) layers of the reference --
proof parsing, the verifier spec, hint preparation, the circuit builder, the
native host kernels -- are copies of its modules at the same paths (a module
whose torch twin shares its name is copied beside it as `<name>_host.py`).
Nothing here imports jax or the JAX package.
"""
