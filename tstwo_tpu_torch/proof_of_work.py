"""Proof-of-work grind: find the smallest nonce whose mixed digest has
>= pow_bits trailing zeros (reference backend/cpu/grind.ts:31-42).

Host-side scan: at the default pow_bits of 5 it takes ~32 Blake2s hashes.
"""
from __future__ import annotations


def grind_host(channel, pow_bits: int) -> int:
    nonce = 0
    while True:
        ch = channel.clone()
        ch.mix_u64(nonce)
        if ch.trailing_zeros() >= pow_bits:
            return nonce
        nonce += 1
