"""The comparison that decides `correct`: the program's proof against the
reference's, field by field.

Each part of the proof is one number compared, the count of its fields
that differ (a field missing on one side counts as differing), with the
limit 0: a proof is exact or it is a different result.  A configuration
names its parts in `proof_parts` (number compared -> the proof's keys it
covers); without that key they are a STARK proof's, `PARTS`.  A key that
neither proof holds counts as differing, so a proof that holds none of
its configuration's parts is not correct.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

# number compared -> the parts of a STARK proof it covers
PARTS = {
    "commitments": ("commitments",),  # the CFFTs, the Merkle roots
    "oods_values": ("sampled_values",),  # constraints, the OODS fold
    "fri": ("fri",),  # DEEP quotients, folds, layer roots, last layer
    "proof_of_work": ("proof_of_work",),  # the grind
    "decommitment": ("queried_values", "decommitments"),
}
LIMIT = 0
# the checks a run prints after the parts: no part takes their names
RUN_CHECKS = ("failed_proofs", "proofs_compared")


def parts_of(config: dict) -> Dict[str, Sequence[str]]:
    """The numbers compared for a configuration, in order: its
    `proof_parts`, else a STARK proof's."""
    declared = config.get("proof_parts")
    if declared is None:
        return dict(PARTS)
    parts = {name: tuple(keys) for name, keys in declared.items()}
    if not parts or not all(parts.values()):
        raise ValueError(f"proof parts compare nothing: {declared!r}")
    taken = set(parts) & set(RUN_CHECKS)
    if taken:
        raise ValueError(f"proof parts named as a run's checks: {taken}")
    return parts


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


def _key(program: Dict[str, Any], reference: Dict[str, Any], key: str) -> int:
    if key not in program and key not in reference:
        return 1  # a declared part that neither proof holds
    return differing(program.get(key), reference.get(key))


def compare(program: Dict[str, Any], reference: Dict[str, Any],
            parts: Optional[Dict[str, Sequence[str]]] = None
            ) -> Dict[str, int]:
    """Fields that differ, a count per number compared of `parts` (a STARK
    proof's without them; `parts_of` a configuration's)."""
    parts = PARTS if parts is None else parts
    return {name: sum(_key(program, reference, k) for k in keys)
            for name, keys in parts.items()}
