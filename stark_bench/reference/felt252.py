"""Felt252 arithmetic, the Hades permutation, Poseidon252 Merkle layers and
the proof-of-work scan of a Poseidon252 channel, vectorised in plain
PyTorch over batches of felts, for the reference of the Poseidon252 cells.

Written from p = 2^251 + 17 * 2^192 + 1 and the definitions of `hashes.py`
(`hades`, `poseidon_hash_many`, `Poseidon252Channel`), which hash one
Python int at a time and which the tests hold this module to.

A felt is ten limbs of 26 bits, least significant first, on the
second-to-last axis: a batch of n felts is an int64 tensor [..., 10, n].
A product is a Montgomery product of radix R = 2^260: the ten rows of limb
products into twenty columns (each below 10 * 2^54), then ten reduction
steps; p's limbs are {0: 1, 7: 17 * 2^10, 9: 2^17} and p == 1 mod 2^26,
so a step's factor m is minus the limb (mod 2^26) and m * p lands on three
limbs.  Inside a permutation values are kept loosely: limbs carried in
parallel passes (each limb below about 2^26, the top one holding the rest,
signed), values in (-2^236, 2p), which the products take as they are:
REDC(a b) lies in (a b / R, a b / R + p).  After the MDS a value below 18p
is brought back by subtracting q p, q its bits from 251 up.  A value is
made canonical (in [0, p), limbs carried in order) only where it leaves:
a digest.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import torch

from .hashes import P252, _FULL_ROUNDS, _PARTIAL_ROUNDS, _ROUND_CONSTANTS
from .merkle import Poseidon252Tree

LIMB = 26
N_LIMBS = 10
MASK = (1 << LIMB) - 1
R = 1 << (LIMB * N_LIMBS)
P7 = 17 << 10          # p's limb 7 (2^192 = limb 7 at bit 10)
P9 = 1 << 17           # p's limb 9 (2^251 = limb 9 at bit 17)
TOP_SHIFT = 251 - LIMB * (N_LIMBS - 1)  # bits of the top limb below 2^251
M31_BITS = 31
M31_PER_FELT = 8
# Nodes of a layer up to which `Poseidon252Layers` hashes on the host, one
# node at a time (`hashes.poseidon_hash_many`): a vectorised permutation is
# ~20,000 tensor operations whatever the batch, a host one ~0.5 ms.
HOST_LAYER_NODES = 256
# Nonces a batch of the proof-of-work scan: pow_bits 26 expects ~2^21 (the
# channel's trailing zeros start at bit 248 of a felt below 2^252).
SCAN_BATCH = 1 << 21


def _limbs_of(v: int) -> List[int]:
    return [(v >> (LIMB * i)) & MASK for i in range(N_LIMBS)]


def from_ints(vals: Sequence[int], device) -> torch.Tensor:
    """Python ints in [0, p) -> canonical limbs [10, n] on `device`."""
    return torch.tensor([_limbs_of(v) for v in vals], dtype=torch.int64,
                        device=device).reshape(len(vals), N_LIMBS).t()


def to_ints(x: torch.Tensor) -> List[int]:
    """Canonical limbs [10, n] -> n Python ints."""
    rows = x.t().tolist()
    return [sum(limb << (LIMB * i) for i, limb in enumerate(r))
            for r in rows]


@lru_cache(maxsize=None)
def _constants(device: torch.device):
    """p's limbs [10, 1], R^2 mod p and 1 as limbs [10, 1], the round
    constants in Montgomery form [91, 3, 10, 1], the MDS's coefficients
    [3, 1, 1], the multiples of p that keep its rows positive [3, 10, 1],
    and p's limbs 7 and 9 [2, 1], on `device`."""
    def col(v):
        return torch.tensor(_limbs_of(v), dtype=torch.int64,
                            device=device)[:, None]

    ark = torch.tensor([[_limbs_of(c * R % P252) for c in row]
                        for row in _ROUND_CONSTANTS], dtype=torch.int64,
                       device=device)[..., None]
    # rows t + 2 s0, t - 2 s1, t - 3 s2 for s_k below 2p
    coef = torch.tensor([2, -2, -3], dtype=torch.int64,
                        device=device)[:, None, None]
    lift = torch.stack([col(0), col(4 * P252), col(6 * P252)])
    p79 = torch.tensor([[P7], [P9]], dtype=torch.int64, device=device)
    return col(P252), col(R * R % P252), col(1), ark, coef, lift, p79


def _spread(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry passes, in place: limbs 0-8 keep their low 26 bits
    and hand the rest up; the top limb keeps what exceeds it.  A pass
    leaves limb i below 2^26 + (limb i-1's bound) / 2^26: limbs below 2^58
    in magnitude end below 2^27 after two passes, below 2^62 after three."""
    for _ in range(passes):
        c = x[..., :N_LIMBS - 1, :] >> LIMB
        x[..., :N_LIMBS - 1, :] &= MASK
        x[..., 1:, :] += c
    return x


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b / R mod p, loosely: limbs of a, b below ~2^27 in magnitude,
    values in (-2^236, 4p); the result's value lies in (a b / R,
    a b / R + p), so in (-2^230, 1.1p), its limbs spread."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    t = torch.zeros(shape[:-2] + (2 * N_LIMBS, shape[-1]), dtype=torch.int64,
                    device=b.device)
    for i in range(N_LIMBS):
        t[..., i:i + N_LIMBS, :].addcmul_(a[..., i:i + 1, :], b)
    p79 = _constants(b.device)[6]
    for i in range(N_LIMBS):
        # minus the step's factor, in (-2^26, 0]: t_i - m_neg is a multiple
        # of 2^26, carried up; t - m_neg p gains -m_neg p's limbs 7 and 9
        m_neg = torch.remainder(t[..., i, :], -(1 << LIMB))
        t[..., i + 1, :] += (t[..., i, :] - m_neg) >> LIMB
        t[..., i + 7:i + 10:2, :].addcmul_(m_neg.unsqueeze(-2), p79,
                                          value=-1)
    return _spread(t[..., N_LIMBS:, :].clone(), 2)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """A value below ~2^256 with spread limbs -> the same mod p in
    (-2^236, p): minus q p, q = the top limb's bits from 251 up."""
    q = x[..., N_LIMBS - 1:, :] >> TOP_SHIFT
    x[..., :1, :] -= q
    x[..., 7:8, :].sub_(q, alpha=P7)
    x[..., N_LIMBS - 1:, :].sub_(q, alpha=P9)
    return x


def canonical(x: torch.Tensor) -> torch.Tensor:
    """A loose value in (-p, 2p) -> [0, p) with limbs carried in order."""
    p = _constants(x.device)[0]

    def carried(v):
        limbs = list(v.unbind(-2))
        for i in range(N_LIMBS - 1):
            limbs[i + 1] = limbs[i + 1] + (limbs[i] >> LIMB)
            limbs[i] = limbs[i] & MASK
        return torch.stack(limbs, dim=-2)

    x = carried(x)
    x = torch.where(x[..., -1:, :] < 0, carried(x + p), x)
    d = carried(x - p)
    return torch.where(d[..., -1:, :] < 0, x, d)


def to_mont(x: torch.Tensor) -> torch.Tensor:
    return mont_mul(x, _constants(x.device)[1])


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical value."""
    return canonical(mont_mul(x, _constants(x.device)[2]))


def _cube(x: torch.Tensor) -> torch.Tensor:
    return mont_mul(mont_mul(x, x), x)


def hades_mont(s: torch.Tensor) -> torch.Tensor:
    """The Hades permutation of states [3, 10, n] in Montgomery form,
    loosely; a new tensor."""
    _, _, _, ark, coef, lift, _ = _constants(s.device)
    half = _FULL_ROUNDS // 2
    s = s.clone()
    for r in range(_FULL_ROUNDS + _PARTIAL_ROUNDS):
        s += ark[r]
        if r < half or r >= half + _PARTIAL_ROUNDS:
            s = _cube(s)
        else:
            s[2:] = _cube(s[2:])
        s = _fold(_spread(s * coef + s.sum(dim=0) + lift, 3))
    return s


def hades(state: torch.Tensor) -> torch.Tensor:
    """The permutation of canonical states [3, 10, n]: canonical [3, 10, n]."""
    return from_mont(hades_mont(to_mont(state)))


def hash_many(felts: Sequence[torch.Tensor]) -> torch.Tensor:
    """poseidon_hash_many of n rows of k canonical felts, column j of the
    rows in felts[j] ([10, n] each): the sponge of rate 2 padded with 1 and
    then 0 to an even count.  Returns canonical [10, n]."""
    n, device = felts[0].shape[-1], felts[0].device
    one = torch.zeros((N_LIMBS, n), dtype=torch.int64, device=device)
    one[0] = 1
    vals = [to_mont(f) for f in felts] + [to_mont(one)]
    if len(vals) % 2:
        vals.append(torch.zeros_like(one))
    s = torch.zeros((3, N_LIMBS, n), dtype=torch.int64, device=device)
    for i in range(0, len(vals), 2):
        s[0] += vals[i]
        s[1] += vals[i + 1]
        s = hades_mont(s)
    return from_mont(s[0])


def pack_m31(block: torch.Tensor) -> torch.Tensor:
    """Eight rows of M31 values [8, n] (int64) as one felt a column, the
    first value highest, 31 bits each: canonical [10, n] (below 2^248)."""
    n = block.shape[-1]
    x = torch.zeros((N_LIMBS, n), dtype=torch.int64, device=block.device)
    for j in range(M31_PER_FELT):
        at = M31_BITS * (M31_PER_FELT - 1 - j)
        k, shift = divmod(at, LIMB)
        wide = block[j] << shift  # below 2^56
        x[k] += wide & MASK
        x[k + 1] += (wide >> LIMB) & MASK
        if k + 2 < N_LIMBS:
            x[k + 2] += wide >> (2 * LIMB)
    return canonical(x)


class Poseidon252Layers:
    """The tree hasher `merkle.MerkleTree` takes, as `merkle.Poseidon252Tree`
    packs: node i hashes (left child, right child, when the layer has
    children) then its columns' values, eight M31 to a felt, first value
    highest, the last felt padded with zero values.  A layer is canonical
    limbs [10, nodes]; layers of at most HOST_LAYER_NODES nodes, and nodes
    that hash nothing, are hashed on the host by `merkle.Poseidon252Tree`,
    held as the same limbs."""

    @staticmethod
    def hash_layer(prev, columns: List[torch.Tensor], n: int, device):
        if n <= HOST_LAYER_NODES or (prev is None and not columns):
            host_prev = None if prev is None else to_ints(prev)
            return from_ints(Poseidon252Tree.hash_layer(
                host_prev, columns, n, device), device)
        felts = [] if prev is None else [prev[:, 0::2], prev[:, 1::2]]
        if columns:
            stacked = torch.stack([c.to(torch.int64) for c in columns])
            pad = -stacked.shape[0] % M31_PER_FELT
            if pad:
                stacked = torch.cat([stacked, stacked.new_zeros(
                    (pad, n))])
            felts += [pack_m31(b) for b in stacked.split(M31_PER_FELT)]
        return hash_many(felts)

    @staticmethod
    def digests(layer, idxs: Sequence[int]) -> List[int]:
        if not idxs:
            return []
        idx = torch.tensor(list(idxs), dtype=torch.int64, device=layer.device)
        return to_ints(layer.index_select(1, idx))


def trailing_zeros(x: torch.Tensor) -> torch.Tensor:
    """`Poseidon252Channel.trailing_zeros` of canonical digests [10, n], as
    int64 [n]: bits 248 and up, then 240-247, 232-239, ..., 128-135 (the
    first 16 of the felt's 32 big-endian bytes read as one LE u128), the
    zeros counted from the first of them (128 when all are zero)."""
    n = x.shape[-1]
    tz = torch.zeros(n, dtype=torch.int64, device=x.device)
    open_ = torch.ones(n, dtype=torch.bool, device=x.device)
    for byte in range(16):
        at = 8 * (31 - byte)  # the byte's lowest bit in the felt
        k, shift = divmod(at, LIMB)
        v = x[k] >> shift
        if shift + 8 > LIMB:
            v = v | (x[k + 1] << (LIMB - shift))
        v = v & 0xFF
        low = torch.zeros_like(tz)
        for bit in range(8):
            low = torch.where((low == bit) & ((v >> bit) & 1 == 0), bit + 1,
                              low)
        tz = tz + torch.where(open_, low, 0)
        open_ = open_ & (v == 0)
    return tz


def least_nonce(digest: int, pow_bits: int, device,
                batch: int = SCAN_BATCH) -> int:
    """The least nonce whose `Poseidon252Channel.mix_u64` digest from
    `digest` has >= pow_bits trailing zeros: batches of `batch` nonces from
    0, each nonce's digest poseidon_hash_many([digest, nonce]), the nonce
    as the felt of words [0, 0, 0, 0, 0, hi, lo] (its own value)."""
    start = 0
    d = from_ints([digest], device)
    while True:
        nonces = torch.arange(start, start + batch, dtype=torch.int64,
                              device=device)
        felts = torch.stack([(nonces >> (LIMB * i)) & MASK
                             for i in range(N_LIMBS)])
        out = hash_many([d.expand(N_LIMBS, batch), felts])
        hits = torch.nonzero(trailing_zeros(out) >= pow_bits)
        if hits.numel():
            return start + int(hits[0, 0])
        start += batch
