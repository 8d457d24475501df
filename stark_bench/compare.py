"""The comparison that decides `correct`: the program's proof against the
reference's, field by field.

Each part of the proof is one number compared, the count of its fields
that differ (a field missing on one side counts as differing), with the
limit 0: a proof is exact or it is a different result.
"""
from __future__ import annotations

from typing import Any, Dict

# number compared -> the parts of the proof it covers
PARTS = {
    "commitments": ("commitments",),  # the CFFTs, the Merkle roots
    "oods_values": ("sampled_values",),  # constraints, the OODS fold
    "fri": ("fri",),  # DEEP quotients, folds, layer roots, last layer
    "proof_of_work": ("proof_of_work",),  # the grind
    "decommitment": ("queried_values", "decommitments"),
}
LIMIT = 0


def _leaves(x: Any) -> int:
    if isinstance(x, dict):
        return sum(_leaves(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_leaves(v) for v in x)
    return 1


def differing(a: Any, b: Any) -> int:
    if isinstance(a, dict) and isinstance(b, dict):
        return sum(differing(a.get(k), b.get(k)) if k in a and k in b
                   else _leaves(a.get(k, b.get(k))) for k in set(a) | set(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        common = min(len(a), len(b))
        return (sum(differing(x, y) for x, y in zip(a, b))
                + sum(_leaves(x) for x in a[common:])
                + sum(_leaves(y) for y in b[common:]))
    return 0 if a == b and type(a) is type(b) else max(_leaves(a), _leaves(b))


def compare(program: Dict[str, Any], reference: Dict[str, Any]
            ) -> Dict[str, int]:
    return {name: sum(differing(program.get(k), reference.get(k))
                      for k in keys)
            for name, keys in PARTS.items()}
