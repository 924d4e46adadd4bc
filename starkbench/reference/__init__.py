"""The plain reference that decides whether a run is correct.

Plain Python (ints, ``hashlib``): the prime field, the Rescue-Prime hash
and its chain, the proof's wire format and Fiat-Shamir transcript, and a
STARK verifier for the two AIRs the benchmark proves (the RPSSS signature
and the Rescue-permutation chain).  It follows the STARK Anatomy
tutorial's protocol, on which the measured package is built, and imports
nothing of that package, of JAX, or of PyTorch.
"""
