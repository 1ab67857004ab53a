"""Device-resident PlonkWithPoseidon prover on torch tensors.

Twin of recursive_stwo_tpu/prover/device_prove.py::prove_device: the trace is
uploaded once, every LDE, Merkle level, interaction, composition and FRI
layer is made and kept on the device, and only roots, sums, samples and the
queried rows come back to the host.  The Fiat-Shamir channel, the decommit
plans and the proof containers are the JAX package's own host code.
"""
