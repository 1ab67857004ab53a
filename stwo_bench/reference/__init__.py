"""The plain reference the benchmark holds the port to.

`verifier/stark.py` verifies one proof at a time over its parsed bytes, as
stwo's verifier does, and gives each named check; `check_verify` works out
a verifier batch's verdicts with it, and `check_proof` holds a proof to the
configuration and to its trace.  Numpy and plain torch alone: it imports
nothing of the program, of JAX or of the JAX package, and takes nothing the
program made but the outputs it judges.
"""
