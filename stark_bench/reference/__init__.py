"""The plain reference prover that decides `correct`.

Plain PyTorch (any device) and the standard library, written from the
Circle STARK protocol as stwo defines it: fields and circle domains
(`algebra`), the circle FFT (`algebra`), Blake2s and Poseidon252 with their
Fiat-Shamir channels (`hashes`), mixed-size Merkle trees (`merkle`) and the
prover of the wide Fibonacci AIR with DEEP quotients, FRI, the grind and
the decommitment (`prover`).  It imports nothing of the program under test
and takes nothing the program made: from the same trace inputs and the same
security settings it makes the whole proof itself, and the harness compares
the program's proof with it field by field.
"""
