"""Batched sum-check protocol (reference lookups/sumcheck.ts)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..fields import M31, QM31
from ..tracing import count
from .utils import (UnivariatePoly, random_linear_combination_polys)

MAX_DEGREE = 3


class SumcheckError(Exception):
    @staticmethod
    def degree_invalid(round_index: int) -> "SumcheckError":
        return SumcheckError(
            f"degree of the polynomial in round {round_index} is too high")

    @staticmethod
    def sum_invalid(claim, total, round_index: int) -> "SumcheckError":
        return SumcheckError(
            f"sum does not match the claim in round {round_index} "
            f"(sum {total}, claim {claim})")


@dataclass
class SumcheckProof:
    round_polys: List[UnivariatePoly]


def prove_batch(claims: List[QM31], polys: List, lambda_: QM31, channel
                ) -> Tuple[SumcheckProof, List[QM31], List, List[QM31]]:
    """Sum-check over h = sum_i lambda^i g_i (reference sumcheck.ts:99-172).

    Returns (proof, assignment, constant oracles, claimed evals).  The
    counter `sumcheck_rounds` adds one a round.
    """
    if not polys:
        raise ValueError("no multivariate polynomials provided")
    if len(claims) != len(polys):
        raise ValueError("claims/polys length mismatch")
    n_variables = max(p.n_variables() for p in polys)
    claims = list(claims)
    polys = list(polys)

    # account for unused variables doubling the sum
    for i in range(len(claims)):
        unused = n_variables - polys[i].n_variables()
        claims[i] = claims[i].mul_m31(M31.from_int(1 << unused))

    round_polys: List[UnivariatePoly] = []
    assignment: List[QM31] = []
    for round_index in range(n_variables):
        n_remaining = n_variables - round_index
        this_round = []
        for i, poly in enumerate(polys):
            claim = claims[i]
            if n_remaining == poly.n_variables():
                rp = poly.sum_as_poly_in_first_variable(claim)
            else:
                rp = UnivariatePoly.from_value(
                    claim.mul_m31(M31.from_int(2).inverse()))
            e0 = rp.eval_at_point(QM31.zero())
            e1 = rp.eval_at_point(QM31.one())
            if e0 + e1 != claim:
                raise ValueError(
                    f"round polynomial check failed: i={i}, round={round_index}")
            if rp.degree() > MAX_DEGREE:
                raise ValueError(
                    f"polynomial degree too high: i={i}, round={round_index}")
            this_round.append(rp)
        round_poly = random_linear_combination_polys(this_round, lambda_)
        channel.mix_felts(round_poly.get_coeffs())
        challenge = channel.draw_felt()
        claims = [rp.eval_at_point(challenge) for rp in this_round]
        polys = [p if n_remaining != p.n_variables()
                 else p.fix_first_variable(challenge) for p in polys]
        round_polys.append(round_poly)
        assignment.append(challenge)
        count("sumcheck_rounds", 1)

    return SumcheckProof(round_polys), assignment, polys, claims


def partially_verify(claim: QM31, proof: SumcheckProof, channel
                     ) -> Tuple[List[QM31], QM31]:
    """reference sumcheck.ts:198-227."""
    assignment: List[QM31] = []
    for round_index, rp in enumerate(proof.round_polys):
        if rp.degree() > MAX_DEGREE:
            raise SumcheckError.degree_invalid(round_index)
        total = rp.eval_at_point(QM31.zero()) + rp.eval_at_point(QM31.one())
        if claim != total:
            raise SumcheckError.sum_invalid(claim, total, round_index)
        channel.mix_felts(rp.get_coeffs())
        challenge = channel.draw_felt()
        claim = rp.eval_at_point(challenge)
        assignment.append(challenge)
    return assignment, claim
