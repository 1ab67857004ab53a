"""The port's provers on torch tensors.

Four entry points, each byte-identical to its JAX package twin:
`prove.prove` (PlonkWithPoseidon) and `prove_np.prove_np`
(PlonkWithoutPoseidon, the last layer's output AIR) with resident trees,
and `stream.prove_streamed` / `stream.prove_np_streamed` with streamed
ones.  Each picks its flavour (`prove.flavour`: the Poseidon31 channel and
`DeviceTree`, or the SHA-256 channel and `Sha256DeviceTree`) and hands
flow.py's `prove_air` the AIR and the commitment; `prove_air` runs every
stage once, from the trace upload to the FRI tail.  The Fiat-Shamir
channel, the decommit plans and the proof containers are the JAX package's
own host code, copied.
"""
