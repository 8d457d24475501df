"""Batched Poseidon252 (Starknet Hades) over felt252 tensors.

A felt252 is eight 32-bit words, least significant first, and a batch of n
felts is an int32 tensor [8, n] (word-major, int32 bit-views of u32): the
shape of a Blake2s Merkle layer, so one Merkle prover serves both
flavours.  Values are below p = 2^251 + 17 * 2^192 + 1.  The JAX package
spreads a felt over 21 limbs of 12 bits (the TPU has no wide multiply);
the functions here have its names and its values, not its layout: Python
ints go in and out through `ints_to_felts` / `felts_to_ints`.

Three functions have a hand-written kernel (csrc/poseidon252.cu) beside
their plain version: `hades_permutation` (a batch of states),
`merkle_layer` (one layer of a Poseidon252 Merkle tree: child pairs and
column values read where they lie, packed, hashed) and
`poseidon_grind_batch` (the least proof-of-work nonce of a range for a
Poseidon252 channel).  A CUDA tensor or device goes to the kernel, the CPU
to the plain version.  `add`, `sub`, `mul` and `pack_m31_columns` are
plain on any device.

The plain versions compute in int64 on 9 limbs of 28 bits, so that a
column of limb products (9 x 2^56) stays below 2^63, with Montgomery
products of radix 2^252.  p in such limbs is {0: 1, 6: 2^24, 7: 1,
8: 2^27} and p == 1 mod 2^28, so the Montgomery factor of a step is minus
the limb and a step touches three limbs beyond it.  `>>` on a negative
int64 is arithmetic, which the carries rely on.

Parity: exact against channel/poseidon.py `hades_permutation` /
`poseidon_hash_many` (Python ints, pinned to stwo's test values).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..channel.poseidon import _ARK, _N_ROUNDS, _R_F, P252
from ..utils import (as_int32_bits, entry_device, to_host_list,
                     to_numpy_u32, to_torch_u32)
from .blake2s import grind_trailing_zeros

LIMB_BITS = 28
N_LIMBS = 9                     # 9 * 28 = 252
_MASK = (1 << LIMB_BITS) - 1
_R = 1 << (LIMB_BITS * N_LIMBS)  # Montgomery radix of the plain versions
_U32 = 0xFFFFFFFF
ELEMENTS_IN_BLOCK = 8            # M31 values packed into one felt

# The kernels' Montgomery radix (csrc/felt252.cuh) and the constants they
# read: 91 x 3 round constants in Montgomery form, R^2 mod p, R mod p.
_KERNEL_R = 1 << 256


def _int_to_words(v: int) -> List[int]:
    return [(v >> (32 * w)) & _U32 for w in range(8)]


def ints_to_felts(vals: Sequence[int], device=None) -> torch.Tensor:
    """Python ints below p -> int32 [8, n] on `device`, CUDA device 0
    unless named."""
    for v in vals:
        if not 0 <= v < P252:
            raise ValueError("felt252 out of range")
    arr = np.array([_int_to_words(v) for v in vals], dtype=np.uint32)
    return to_torch_u32(arr.reshape(len(vals), 8).T, entry_device(device))


def felts_to_ints(felts: torch.Tensor) -> List[int]:
    """int32 [8, n] (any device) -> n Python ints."""
    host = to_numpy_u32(felts).astype(object)
    return [sum(int(host[w, i]) << (32 * w) for w in range(8))
            for i in range(host.shape[1])]


# ---------------------------------------------------------------------------
# Plain arithmetic on int64 limb tensors [..., 9, n]
# ---------------------------------------------------------------------------

def _int_to_limbs(v: int) -> List[int]:
    return [(v >> (LIMB_BITS * i)) & _MASK for i in range(N_LIMBS)]


@lru_cache(maxsize=None)
def _limb_constants(device: torch.device):
    """p, R^2 mod p and 1 as limb columns [9, 1], and the round constants
    in Montgomery form [91, 3, 9, 1], on `device`."""
    def col(v):
        return torch.tensor(_int_to_limbs(v), dtype=torch.int64,
                            device=device)[:, None]

    ark = torch.tensor([[_int_to_limbs(c * _R % P252) for c in row]
                        for row in _ARK], dtype=torch.int64,
                       device=device)[..., None]
    return col(P252), col(_R * _R % P252), col(1), ark


def _words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., 8, n] words of values below 2^252 -> int64 [..., 9, n]."""
    w = (words.to(torch.int64) & _U32).unbind(-2)
    limbs = []
    for k in range(N_LIMBS):
        at, shift = divmod(LIMB_BITS * k, 32)
        v = w[at] >> shift
        if 32 - shift < LIMB_BITS and at + 1 < 8:
            v = v | (w[at + 1] << (32 - shift))
        limbs.append(v & _MASK)
    return torch.stack(limbs, dim=-2)


def _limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """int64 [..., 9, n] limbs in [0, 2^28) -> int32 [..., 8, n]."""
    ls = limbs.unbind(-2)
    words = []
    for j in range(8):
        k, shift = divmod(32 * j, LIMB_BITS)
        v, have = ls[k] >> shift, LIMB_BITS - shift
        while have < 32 and k + 1 < N_LIMBS:
            k += 1
            v = v | (ls[k] << have)
            have += LIMB_BITS
        words.append(v & _U32)
    return as_int32_bits(torch.stack(words, dim=-2))


def _ripple(x: torch.Tensor) -> torch.Tensor:
    """Carry limb by limb (limbs may be any int64, the value not negative):
    limbs 0-7 end in [0, 2^28), the top limb keeps what exceeds 252 bits,
    or the sign of a negative value."""
    limbs = x.unbind(-2)
    out, carry = [], 0
    for i in range(N_LIMBS - 1):
        v = limbs[i] + carry
        out.append(v & _MASK)
        carry = v >> LIMB_BITS
    out.append(limbs[-1] + carry)
    return torch.stack(out, dim=-2)


def _cond_sub_p(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x - p if x >= p else x, for carried x below 2p."""
    d = _ripple(x - p)
    return torch.where(d[..., -1:, :] < 0, x, d)


def _limb_add(a, b, p):
    return _cond_sub_p(_ripple(a + b), p)


def _reduce(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Limbs of any sign whose value lies in [0, 2^54 p) -> the value mod p.
    With q = floor(x / 2^251), x - (q - 1) p lies in (0, 2p)."""
    x = _ripple(x)
    q = x[..., -1:, :] >> (251 - LIMB_BITS * (N_LIMBS - 1))
    return _cond_sub_p(_ripple(x + (1 - q) * p), p)


def _mont_mul(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor
              ) -> torch.Tensor:
    """a * b / 2^252 mod p for carried a, b below p."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    t = torch.zeros(shape[:-2] + (2 * N_LIMBS, shape[-1]), dtype=torch.int64,
                    device=a.device)
    for i in range(N_LIMBS):  # every column sum stays below 9 * 2^56
        t[..., i:i + N_LIMBS, :] += a[..., i:i + 1, :] * b
    t = list(t.unbind(-2))
    carry = 0
    for i in range(N_LIMBS):
        v = t[i] + carry
        m = (-v) & _MASK
        carry = (v + m) >> LIMB_BITS        # + m * p[0]: the limb cancels
        t[i + 6] = t[i + 6] + (m << 24)     # + m * p[6], p[7], p[8]
        t[i + 7] = t[i + 7] + m
        t[i + 8] = t[i + 8] + (m << 27)
    t[N_LIMBS] = t[N_LIMBS] + carry
    # (a b + m p) / R < 2p
    return _cond_sub_p(_ripple(torch.stack(t[N_LIMBS:], dim=-2)), p)


def _cube(x, p):
    return _mont_mul(_mont_mul(x, x, p), x, p)


def _hades_limbs(s: torch.Tensor) -> torch.Tensor:
    """The permutation of states [3, 9, n] in Montgomery form."""
    p, _, _, ark = _limb_constants(s.device)
    half = _R_F // 2
    for r in range(_N_ROUNDS):
        s = _limb_add(s, ark[r], p)
        if r < half or r >= _N_ROUNDS - half:
            s = _cube(s, p)
        else:
            s = torch.cat([s[:2], _cube(s[2:], p)])
        # MDS [[3,1,1],[1,-1,1],[1,1,-2]] on the limbs as they are, each
        # row shifted by a multiple of p into [0, 5p), then reduced at once
        s0, s1, s2 = s.unbind(0)
        t = s0 + s1 + s2
        s = _reduce(torch.stack([t + 2 * s0, t - 2 * s1 + p,
                                 t - 3 * s2 + 2 * p]), p)
    return s


# ---------------------------------------------------------------------------
# Field operations on felts [8, n] (plain on any device)
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for a, b below p."""
    p = _limb_constants(a.device)[0]
    return _limbs_to_words(_limb_add(_words_to_limbs(a), _words_to_limbs(b),
                                     p))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for a, b below p."""
    p = _limb_constants(a.device)[0]
    return _limbs_to_words(_limb_add(_words_to_limbs(a),
                                     p - _words_to_limbs(b), p))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p for a, b below p."""
    p, r2, _, _ = _limb_constants(a.device)
    ab = _mont_mul(_words_to_limbs(a), _words_to_limbs(b), p)  # a b / R
    return _limbs_to_words(_mont_mul(ab, r2, p))


def pack_m31_columns(cols: torch.Tensor) -> torch.Tensor:
    """Pack 8 M31 values per felt252 (first value highest, 31 bits each,
    248 bits in all, below p): cols int32 [8, n] of canonical M31 -> felts
    [8, n]."""
    if cols.shape[0] != ELEMENTS_IN_BLOCK:
        raise ValueError("expected exactly 8 M31 rows")
    v = cols.to(torch.int64)
    words = [torch.zeros_like(v[0]) for _ in range(8)]
    for j in range(ELEMENTS_IN_BLOCK):
        at, shift = divmod(31 * (7 - j), 32)
        wide = v[j] << shift
        words[at] = words[at] | (wide & _U32)
        if at + 1 < 8:
            words[at + 1] = words[at + 1] | (wide >> 32)
    return as_int32_bits(torch.stack(words))


# ---------------------------------------------------------------------------
# The Hades permutation
# ---------------------------------------------------------------------------

def _state_tensor(state) -> torch.Tensor:
    """Three felt batches [8, n], or one tensor [3, 8, n], as [3, 8, n]."""
    s = state if isinstance(state, torch.Tensor) else torch.stack(list(state))
    if s.ndim != 3 or tuple(s.shape[:2]) != (3, 8):
        raise ValueError(f"state: expected three [8, n] felt batches, got "
                         f"{tuple(s.shape)}")
    return s


def hades_permutation_plain(state) -> List[torch.Tensor]:
    """Plain PyTorch version on any device."""
    s = _state_tensor(state)
    p, r2, one, _ = _limb_constants(s.device)
    s = _hades_limbs(_mont_mul(_words_to_limbs(s), r2, p))
    return list(_limbs_to_words(_mont_mul(s, one, p)).unbind(0))


_constants_on: set = set()  # CUDA device indices that hold the constants


def _ensure_kernel_constants(device: torch.device) -> None:
    """Upload the round constants to `device` before its first launch."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index in _constants_on:
        return
    felts = [c * _KERNEL_R % P252 for row in _ARK for c in row]
    felts += [_KERNEL_R * _KERNEL_R % P252, _KERNEL_R % P252]
    words = np.array([_int_to_words(v) for v in felts],
                     dtype=np.uint32).reshape(-1)
    with torch.cuda.device(index):
        err = kernels.entry("poseidon_set_constants")(words.ctypes.data,
                                                      words.size)
    if err != 0:
        raise RuntimeError(f"poseidon_set_constants failed: CUDA error {err}")
    _constants_on.add(index)


def hades_permutation_cuda(state) -> List[torch.Tensor]:
    """One launch of csrc/poseidon252.cu's hades_permutation_kernel over a
    batch of CUDA states."""
    s = _state_tensor(state)
    kernels.check_cuda_tensor(s, "state", contiguous=False)
    s = s.contiguous()
    out = torch.empty_like(s)
    if s.shape[2]:
        _ensure_kernel_constants(s.device)
        kernels.launch("hades_permutation", "hades_permutation", s.device,
                       s.data_ptr(), out.data_ptr(), s.shape[2])
    return list(out.unbind(0))


def hades_permutation(state) -> List[torch.Tensor]:
    """Batched Hades permutation (8 full and 83 partial rounds, x^3, MDS
    [[3,1,1],[1,-1,1],[1,1,-2]]).  state: three felt batches int32 [8, n]
    below p (or one tensor [3, 8, n]); returns three."""
    first = state if isinstance(state, torch.Tensor) else state[0]
    if kernels.on_cuda(first):
        return hades_permutation_cuda(state)
    return hades_permutation_plain(state)


def _sponge(felt_cols: Sequence[torch.Tensor], n: int, device, permute
            ) -> torch.Tensor:
    """starknet poseidon_hash_many of n rows: rate 2, padding [1, 0...]."""
    zero = torch.zeros((8, n), dtype=torch.int32, device=device)
    one = zero.clone()
    one[0] = 1
    vals = list(felt_cols) + [one]
    if len(vals) % 2:
        vals.append(zero)
    state = [zero, zero, zero]
    for i in range(0, len(vals), 2):
        state = permute([add(state[0], vals[i]), add(state[1], vals[i + 1]),
                         state[2]])
    return state[0]


def poseidon_hash_many(felt_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Batched starknet poseidon_hash_many over fixed-width inputs:
    felt_cols = k felt batches [8, n]; every row hashes the same number of
    felts.  Returns [8, n]."""
    if not felt_cols:
        raise ValueError("need at least one input felt column")
    return _sponge(felt_cols, felt_cols[0].shape[1], felt_cols[0].device,
                   hades_permutation)


# ---------------------------------------------------------------------------
# One layer of a Poseidon252 Merkle tree
# ---------------------------------------------------------------------------

def merkle_layer_plain(prev: Optional[torch.Tensor],
                       columns: Sequence[torch.Tensor], n: int = 1,
                       device=None) -> torch.Tensor:
    """One Merkle layer in plain PyTorch, on any device: the even/odd split
    of the child layer, the columns stacked, zero padded and packed 8 to a
    felt, the sponge.  `n` and `device` are read only when there is
    neither prev nor column (then `device` is CUDA device 0 unless
    named)."""
    felts = []
    if prev is not None:
        felts += [prev[:, 0::2], prev[:, 1::2]]
        n, device = prev.shape[1] // 2, prev.device
    rows = [c if c.ndim == 2 else c[None, :] for c in columns]
    rows = [c for c in rows if c.shape[0]]
    if rows:
        stacked = torch.cat(rows, dim=0)
        n, device = stacked.shape[1], stacked.device
        pad = -stacked.shape[0] % ELEMENTS_IN_BLOCK
        stacked = torch.nn.functional.pad(stacked, (0, 0, 0, pad))
        felts += [pack_m31_columns(block)
                  for block in stacked.split(ELEMENTS_IN_BLOCK)]
    return _sponge(felts, n, entry_device(device), hades_permutation_plain)


def merkle_layer_cuda(prev: Optional[torch.Tensor],
                      columns: Sequence[torch.Tensor], n: int = 1,
                      device=None) -> torch.Tensor:
    """One Merkle layer in one launch of csrc/poseidon252.cu's
    poseidon_merkle_layer_kernel."""
    if prev is not None:
        kernels.check_cuda_tensor(prev, "prev", contiguous=False)
        n, device = prev.shape[1] // 2, prev.device
        if tuple(prev.shape) != (8, 2 * n):
            raise ValueError(f"prev: expected [8, 2n], got "
                             f"{tuple(prev.shape)}")
        if prev.stride(1) != 1 or prev.stride(0) != 2 * n:
            prev = prev.contiguous()
    elif columns:
        n, device = columns[0].shape[-1], columns[0].device
    device = torch.device(device)
    if not kernels.is_cuda(device):
        raise ValueError(f"expected a CUDA device, got {device}")
    table = kernels.segment_table(columns, n, device)
    out = torch.empty((8, n), dtype=torch.int32, device=device)
    if n:
        _ensure_kernel_constants(device)
        kernels.launch("poseidon_merkle_layer", "poseidon_merkle_layer",
                       device, None if prev is None else prev.data_ptr(),
                       *table.args, out.data_ptr(), n)
    return out


def merkle_layer(prev: Optional[torch.Tensor],
                 columns: Sequence[torch.Tensor], n: int = 1,
                 device=None) -> torch.Tensor:
    """node i = poseidon_hash_many([prev[:, 2i], prev[:, 2i+1]] + the column
    values at i packed 8 to a felt), as the host's hash_node.

    prev: felts [8, 2n] of the child layer, or None at a leaf layer.
    columns: entries [n] or [C, n] of canonical M31, hashed in order.  With
    neither, n hashes of no value on `device` (CUDA device 0 unless
    named).  Returns felts [8, n]."""
    first = prev if prev is not None else (columns[0] if columns else None)
    device = entry_device(device) if first is None else first.device
    if kernels.is_cuda(device):
        return merkle_layer_cuda(prev, columns, n, device)
    return merkle_layer_plain(prev, columns, n, device)


# ---------------------------------------------------------------------------
# The proof-of-work grind of a Poseidon252 channel
# ---------------------------------------------------------------------------

def _grind_args(digest: int, start: int, count: int, pow_bits: int
                ) -> np.ndarray:
    if not 0 <= digest < P252:
        raise ValueError("digest: expected a felt252 below p")
    if count <= 0 or start < 0 or start + count > 1 << 63 or pow_bits < 0:
        raise ValueError(f"grind range [{start}, {start} + {count}) or "
                         f"pow_bits {pow_bits} out of range")
    return np.array(_int_to_words(digest), dtype=np.uint32)


def channel_trailing_zeros(felts: torch.Tensor) -> torch.Tensor:
    """`Poseidon252Channel.trailing_zeros` of digests [8, N] as int64 [N]:
    the first 16 of a felt's 32 big-endian bytes read as one LE u128, that
    is words 7, 6, 5, 4, each byte-reversed, from the low end (128 when all
    four are zero)."""
    w = felts[4:].flip(0).to(torch.int64) & _U32
    swapped = ((w & 0xFF) << 24 | (w >> 8 & 0xFF) << 16
               | (w >> 16 & 0xFF) << 8 | w >> 24)
    return grind_trailing_zeros(swapped)


def poseidon_grind_hit_plain(digest: int, start: int, count: int,
                             pow_bits: int, device=None) -> torch.Tensor:
    """Plain PyTorch version on `device` (CUDA device 0 unless named): the
    mix_u64 digest of every nonce, poseidon_hash_many([digest, nonce]), by
    the plain sponge, its trailing zeros, and the first nonce with >=
    pow_bits of them as an int64 [1] tensor on `device` (-1 if none),
    without a wait for the device."""
    words = _grind_args(digest, start, count, pow_bits)
    device = entry_device(device)
    nonces = start + torch.arange(count, dtype=torch.int64, device=device)
    zero = torch.zeros_like(nonces)
    nonce_felts = as_int32_bits(torch.stack(
        [nonces & _U32, nonces >> 32] + [zero] * 6))
    digests = to_torch_u32(words[:, None], device).expand(8, count)
    hit = channel_trailing_zeros(_sponge([digests, nonce_felts], count,
                                         device, hades_permutation_plain)
                                 ) >= pow_bits
    first = torch.argmax(hit.to(torch.int8))  # the first of the maxima
    return torch.where(hit[first], nonces[first], -1).reshape(1)


def poseidon_grind_hit_cuda(digest: int, start: int, count: int,
                            pow_bits: int, device) -> torch.Tensor:
    """One launch of csrc/poseidon252.cu's grind kernel over the nonces
    [start, start + count) on CUDA `device`: the least hit as an int64 [1]
    tensor on the device (-1 if none), not waited for."""
    words = _grind_args(digest, start, count, pow_bits)
    device = torch.device(device)
    if not kernels.is_cuda(device):
        raise ValueError(f"expected a CUDA device, got {device}")
    _ensure_kernel_constants(device)
    best = torch.full((1,), -1, dtype=torch.int64, device=device)  # all ones
    kernels.launch("poseidon_grind", "poseidon_grind", device,
                   words.ctypes.data, start, count, pow_bits, best.data_ptr())
    return best


def poseidon_grind_batch(digest: int, start: int, count: int, pow_bits: int,
                         device=None) -> int:
    """The least nonce in [start, start + count) whose
    `Poseidon252Channel.mix_u64(nonce)` digest, from the channel digest
    `digest` (an int below p), has >= pow_bits trailing zeros, or -1.  A
    CUDA device (device 0 unless named) launches the kernel and reads 8
    bytes back, the CPU runs the plain version."""
    device = entry_device(device)
    if kernels.is_cuda(device):
        hit = poseidon_grind_hit_cuda(digest, start, count, pow_bits, device)
    else:
        hit = poseidon_grind_hit_plain(digest, start, count, pow_bits, device)
    return to_host_list(hit)[0]
