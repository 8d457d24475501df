"""Mask-point helpers (reference air/mask.ts)."""
from __future__ import annotations

from typing import List, Sequence

from ..circle import CanonicCoset, CirclePoint
from ..fields import QM31


def fixed_mask_points(mask: Sequence[Sequence[int]],
                      point: CirclePoint) -> List[List[CirclePoint]]:
    """All offsets must be 0 (reference air/mask.ts:27-68)."""
    items = {i for col in mask for i in col}
    if items and items != {0}:
        raise ValueError(f"expected all mask items to be 0, found {sorted(items)}")
    return [[point] * len(col) for col in mask]


def shifted_mask_points(mask: Sequence[Sequence[int]],
                        domains: Sequence[CanonicCoset],
                        point: CirclePoint) -> List[List[CirclePoint]]:
    """point + offset * trace_step per mask item (reference air/mask.ts:70-112)."""
    if len(mask) != len(domains):
        raise ValueError("mask / domains length mismatch")
    out = []
    for col_mask, domain in zip(mask, domains):
        pts = []
        for item in col_mask:
            if not 0 <= item < domain.size():
                raise ValueError(
                    f"mask item {item} out of domain bounds [0, {domain.size()})")
            shift = domain.at(item).into_ef(QM31.from_base)
            pts.append(point + shift)
        out.append(pts)
    return out
