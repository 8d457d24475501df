"""Lookup arguments: MLE, sum-check, GKR (GrandProduct + LogUp)."""

from .mle import BaseMle, Mle, SecureMle  # noqa: F401
from .sumcheck import (MAX_DEGREE, SumcheckError, SumcheckProof,  # noqa: F401
                       partially_verify, prove_batch)
from .utils import (Fraction, Reciprocal, UnivariatePoly, eq,  # noqa: F401
                    fold_mle_evals, horner_eval, random_linear_combination,
                    random_linear_combination_polys)
