"""Twiddle precomputation for the circle FFT.

A TwiddleTree for a root coset of log size L holds, for each doubling layer
j = 0..L-1, the bit-reversed x-coordinates of the first half of
root.repeated_double(j) -- plus their modular inverses (the layout of the
reference slow_precompute_twiddles, backend/cpu/circle.ts:210-239, stored
per layer).

Host precompute runs in numpy uint64 (exact).  Device tensors are made on
first use and cached on the tree per device, as are the CFFT kernel's
twiddle buffers per (domain size, direction, device).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..circle import CanonicCoset, Coset
from ..ops import m31
from ..utils import bit_reverse_permutation, entry_device, to_torch_u32

P = (1 << 31) - 1


def _coset_halves_xy(coset: Coset) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) coords of the first half of `coset`, natural order (numpy u64)."""
    half = coset.size() // 2
    init = coset.initial
    xs = np.array([init.x.value], dtype=np.uint64)
    ys = np.array([init.y.value], dtype=np.uint64)
    j = 0
    while len(xs) < half:
        sp = coset.step_size.scale(1 << j).to_point()
        sx, sy = np.uint64(sp.x.value), np.uint64(sp.y.value)
        nx = (xs * sx + P * P - ys * sy) % P
        ny = (xs * sy + ys * sx) % P
        xs = np.concatenate([xs, nx])
        ys = np.concatenate([ys, ny])
        j += 1
    return xs[:half], ys[:half]


def _double_x(x: np.ndarray) -> np.ndarray:
    return (2 * x * x + (P - 1)) % P


@dataclass
class TwiddleTree:
    """Per-layer twiddles for a coset-doubling tower (reference poly/twiddles.ts:15)."""

    root_coset: Coset
    # layers_np[j]: bit-reversed x-coords of first half of root.double^j;
    # sizes 2^(L-1), 2^(L-2), ..., 1
    layers_np: List[np.ndarray]
    ilayers_np: List[np.ndarray]
    _device: Dict[tuple, object] = field(default_factory=dict, repr=False,
                                         compare=False)

    def layer_of_size(self, size: int, inverse: bool = False,
                      device=None) -> torch.Tensor:
        """The twiddle layer of `size` on `device` (CUDA device 0 unless
        named), cached per device."""
        device = entry_device(device)
        key = ("layer", size, inverse, str(device))
        hit = self._device.get(key)
        if hit is None:
            src = self.ilayers_np if inverse else self.layers_np
            arr = next((a for a in src if a.shape[-1] == size), None)
            if arr is None:
                raise ValueError(f"no twiddle layer of size {size}")
            hit = self._device[key] = to_torch_u32(arr, device)
        return hit

    def fft_twiddles(self, log_size: int, inverse: bool, device):
        """(line layers, circle layer, kernel buffer) for a circle domain of
        log size `log_size` >= 3, cached per device."""
        device = torch.device(device)
        key = ("fft", log_size, inverse, str(device))
        hit = self._device.get(key)
        if hit is None:
            from ..ops.fft import twiddle_buffer

            line = domain_line_twiddles(log_size, self, inverse, device)
            circle = circle_layer_twiddles(line[0])
            hit = self._device[key] = (line, circle,
                                       twiddle_buffer(line, circle))
        return hit

    def drop_device_copies(self) -> None:
        """Forget the cached device tensors (layers and kernel buffers);
        they are made anew on the next use.  The host arrays stay."""
        self._device.clear()


_CACHE: Dict[Tuple[int, int], TwiddleTree] = {}


def precompute_twiddles(coset: Coset) -> TwiddleTree:
    key = (coset.initial_index.value, coset.log_size)
    if key in _CACHE:
        return _CACHE[key]
    layers_np: List[np.ndarray] = []
    xs, _ = _coset_halves_xy(coset)
    cur = xs
    for _ in range(coset.log_size):
        perm = bit_reverse_permutation(int(np.log2(len(cur))) if len(cur) > 1 else 0)
        layers_np.append(cur[perm].astype(np.uint32) if len(cur) > 1
                         else cur.astype(np.uint32))
        cur = _double_x(cur[: len(cur) // 2]) if len(cur) > 1 else cur[:0]
    ilayers_np = [m31.np_inv(a) for a in layers_np]
    tree = TwiddleTree(root_coset=coset, layers_np=layers_np,
                       ilayers_np=ilayers_np)
    _CACHE[key] = tree
    return tree


def twiddles_for(evals: Sequence, log_blowup_factor: int) -> TwiddleTree:
    """The twiddles of a prove of the components of `evals` (FrameworkEvals
    or components): they reach the largest domain it uses, the composition
    polynomial's, of the largest constraint bound, extended by the
    blowup."""
    bound = max(e.max_constraint_log_degree_bound() for e in evals)
    return precompute_twiddles(CanonicCoset.new(
        bound + log_blowup_factor).circle_domain().half_coset)


def domain_line_twiddles(domain_log_size: int, tree: TwiddleTree,
                         inverse: bool = False,
                         device=None) -> List[torch.Tensor]:
    """[t_1, ..., t_{n-1}] where t_l (size 2^(n-1-l)) drives fft layer l,
    on `device`, CUDA device 0 unless named (reference poly/utils.ts:78-99)."""
    return [tree.layer_of_size(1 << (domain_log_size - 1 - l), inverse, device)
            for l in range(1, domain_log_size)]


def circle_layer_twiddles(line_layer1: torch.Tensor) -> torch.Tensor:
    """Layer-0 (circle-layer) twiddles from layer-1 line twiddles.

    Consecutive bit-reversed groups of 4 domain points are
    [(x,y), (-x,-y), (y,-x), (-y,x)]; their butterfly twiddles are
    [y, -y, -x, x] where [x, y] are the layer-1 pair
    (reference backend/cpu/circle.ts:270-278).
    """
    x = line_layer1[0::2]
    y = line_layer1[1::2]
    return torch.stack([y, m31.neg(y), m31.neg(x), x], dim=-1).reshape(-1)
