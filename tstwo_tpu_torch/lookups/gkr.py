"""GKR batch prover/verifier for GrandProduct and LogUp lookup arguments.

Layer generation and the per-round sums run on the layers' device over
the hypercube (QM31 SoA int32 [4, n], the ops/qm31 layout); the round
structure (sumcheck, channel interaction) is host-driven.  Each layer step
halves the layer through `ops/fri_ops._deinterleave`, which launches the
deinterleave kernel for a CUDA tensor; a round's sums and folds are
`gkr_kernels.round_sums` and `fold` (one kernel launch each on the card).
reference lookups/gkr_prover.ts + gkr_verifier.ts +
backend/cpu/lookups/gkr.ts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..fields import M31, QM31
from ..ops.fri_ops import _deinterleave
from ..tracing import count, span
from ..utils import entry_device
from . import npqm31
from .gkr_kernels import (GRAND_PRODUCT, LOGUP_GENERIC, LOGUP_MULTIPLICITIES,
                          LOGUP_SINGLES, round_sums)
from .mle import BaseMle, Mle
from .sumcheck import (SumcheckProof, partially_verify as sumcheck_verify,
                       prove_batch as sumcheck_prove_batch)
from .utils import (Fraction, UnivariatePoly, eq, fold_mle_evals,
                    random_linear_combination)


class GkrError(Exception):
    pass


@dataclass
class Layer:
    """One GKR circuit layer (reference gkr_prover.ts:96-266)."""

    kind: str
    data: Optional[Mle] = None            # GrandProduct
    numerators: Optional[object] = None   # Mle | BaseMle
    denominators: Optional[Mle] = None    # LogUp variants

    def n_variables(self) -> int:
        if self.kind == GRAND_PRODUCT:
            return self.data.n_variables()
        return self.denominators.n_variables()

    def is_output_layer(self) -> bool:
        return self.n_variables() == 0

    def device(self) -> torch.device:
        mle = self.data if self.kind == GRAND_PRODUCT else self.denominators
        return mle.evals.device

    def next_layer(self) -> Optional["Layer"]:
        if self.is_output_layer():
            return None
        if self.kind == GRAND_PRODUCT:
            return Layer(GRAND_PRODUCT, data=Mle(_next_gp(self.data.evals)))
        d = self.denominators.evals
        if self.kind == LOGUP_SINGLES:
            num, den = _next_logup_singles(d)
        else:
            if self.kind == LOGUP_MULTIPLICITIES:
                n_arr = self.numerators.to_secure().evals
            else:
                n_arr = self.numerators.evals
            num, den = _next_logup(n_arr, d)
        return Layer(LOGUP_GENERIC, numerators=Mle(num), denominators=Mle(den))

    def try_into_output_layer_values(self) -> List[QM31]:
        if not self.is_output_layer():
            raise GkrError("not an output layer")
        if self.kind == GRAND_PRODUCT:
            return [self.data.at(0)]
        if self.kind == LOGUP_SINGLES:
            return [QM31.one(), self.denominators.at(0)]
        if self.kind == LOGUP_MULTIPLICITIES:
            return [QM31.from_base(self.numerators.at(0)),
                    self.denominators.at(0)]
        return [self.numerators.at(0), self.denominators.at(0)]

    def fix_first_variable(self, x0: QM31) -> "Layer":
        if self.n_variables() == 0:
            return self
        if self.kind == GRAND_PRODUCT:
            return Layer(GRAND_PRODUCT, data=self.data.fix_first_variable(x0))
        if self.kind == LOGUP_SINGLES:
            return Layer(LOGUP_SINGLES,
                         denominators=self.denominators.fix_first_variable(x0))
        return Layer(LOGUP_GENERIC,
                     numerators=self.numerators.fix_first_variable(x0),
                     denominators=self.denominators.fix_first_variable(x0))

    def round_columns(self) -> Tuple[str, tuple]:
        """The kind of gate the round sums evaluate and the columns they
        read: base-field numerators (a BaseMle) are LogUpMultiplicities'."""
        if self.kind == GRAND_PRODUCT:
            return GRAND_PRODUCT, (self.data.evals,)
        if self.kind == LOGUP_SINGLES:
            return LOGUP_SINGLES, (self.denominators.evals,)
        kind = (LOGUP_MULTIPLICITIES if isinstance(self.numerators, BaseMle)
                else LOGUP_GENERIC)
        return kind, (self.numerators.evals, self.denominators.evals)

    def into_multivariate_poly(self, lambda_: QM31,
                               eq_evals: "EqEvals") -> "GkrMultivariatePolyOracle":
        return GkrMultivariatePolyOracle(eq_evals, self, QM31.one(), lambda_)


class EqEvals:
    """eq(x, y) evaluations with the first variable fixed to 0
    (reference gkr_prover.ts:45-95)."""

    def __init__(self, y: List[QM31], evals: Mle):
        self.y = list(y)
        self.evals = evals

    @staticmethod
    def generate(y: Sequence[QM31], device=None) -> "EqEvals":
        """On `device`, CUDA device 0 unless named."""
        device = entry_device(device)
        y = list(y)
        if not y:
            return EqEvals(y, Mle(npqm31.scalar(QM31.one(), 1, device)))
        v = eq([QM31.zero()], [y[0]])
        evals = gen_eq_evals(y[1:], v, device)
        assert len(evals) == 1 << (len(y) - 1)
        return EqEvals(y, evals)

    def at(self, i: int) -> QM31:
        return self.evals.at(i)

    def __len__(self) -> int:
        return len(self.evals)


# ---------------------------------------------------------------------------
# Layer generation: one halving step of the circuit per call
# ---------------------------------------------------------------------------

def _next_gp(ev: torch.Tensor) -> torch.Tensor:
    e0, e1 = _deinterleave(ev)
    return npqm31.mul(e0, e1)


def _next_logup(n_arr: torch.Tensor, d: torch.Tensor):
    d0, d1 = _deinterleave(d)
    n0, n1 = _deinterleave(n_arr)
    return (npqm31.add(npqm31.mul(n0, d1), npqm31.mul(n1, d0)),
            npqm31.mul(d0, d1))


def _next_logup_singles(d: torch.Tensor):
    d0, d1 = _deinterleave(d)
    return npqm31.add(d0, d1), npqm31.mul(d0, d1)


def gen_eq_evals(y: Sequence[QM31], v: QM31, device=None) -> Mle:
    """eq(x, y) * v for all x in {0,1}^n, bit-reversed, on `device` (CUDA
    device 0 unless named) (reference backend/cpu/lookups/gkr.ts:90-108):
    doubles the table once per variable, most-significant variable last."""
    device = entry_device(device)
    arr = npqm31.scalar(v, 1, device)
    for yi in reversed(list(y)):
        tmp = npqm31.mul(arr, npqm31.scalar(yi, 1, device))
        arr = torch.cat([npqm31.sub(arr, tmp), tmp], dim=1)
    return Mle(arr)


@dataclass
class GkrMask:
    """Two evaluations per column of a layer (reference gkr_verifier.ts:256)."""

    columns_: List[Tuple[QM31, QM31]]

    def columns(self) -> List[Tuple[QM31, QM31]]:
        return list(self.columns_)

    def to_rows(self) -> Tuple[List[QM31], List[QM31]]:
        return ([a for a, _ in self.columns_], [b for _, b in self.columns_])

    def reduce_at_point(self, x: QM31) -> List[QM31]:
        return [fold_mle_evals(x, a, b) for a, b in self.columns_]


class GkrMultivariatePolyOracle:
    """reference gkr_prover.ts:299-425."""

    def __init__(self, eq_evals: EqEvals, input_layer: Layer,
                 eq_fixed_var_correction: QM31, lambda_: QM31):
        self.eq_evals = eq_evals
        self.input_layer = input_layer
        self.eq_fixed_var_correction = eq_fixed_var_correction
        self.lambda_ = lambda_

    def n_variables(self) -> int:
        return self.input_layer.n_variables() - 1

    def is_constant(self) -> bool:
        return self.n_variables() == 0

    def sum_as_poly_in_first_variable(self, claim: QM31) -> UnivariatePoly:
        n_variables = self.n_variables()
        if n_variables == 0:
            raise GkrError("number of variables must not be zero")
        n_terms = 1 << (n_variables - 1)
        y = self.eq_evals.y
        eq_arr = self.eq_evals.evals.evals[:, :n_terms]
        kind, cols = self.input_layer.round_columns()
        e0, e2 = round_sums(kind, eq_arr, cols, self.lambda_)
        e0 = e0 * self.eq_fixed_var_correction
        e2 = e2 * self.eq_fixed_var_correction
        return correct_sum_as_poly_in_first_variable(e0, e2, claim, y,
                                                     n_variables)

    def fix_first_variable(self, challenge: QM31) -> "GkrMultivariatePolyOracle":
        if self.is_constant():
            return self
        y = self.eq_evals.y
        z0 = y[len(y) - self.n_variables()]
        corr = self.eq_fixed_var_correction * eq([challenge], [z0])
        return GkrMultivariatePolyOracle(
            self.eq_evals, self.input_layer.fix_first_variable(challenge),
            corr, self.lambda_)

    def try_into_mask(self) -> GkrMask:
        if not self.is_constant():
            raise GkrError("polynomial is not constant")
        layer = self.input_layer
        if layer.kind == GRAND_PRODUCT:
            cols = [(layer.data.at(0), layer.data.at(1))]
        elif layer.kind == LOGUP_SINGLES:
            cols = [(QM31.one(), QM31.one()),
                    (layer.denominators.at(0), layer.denominators.at(1))]
        elif layer.kind == LOGUP_MULTIPLICITIES:
            raise GkrError("LogUpMultiplicities should never reach try_into_mask")
        else:
            cols = [(layer.numerators.at(0), layer.numerators.at(1)),
                    (layer.denominators.at(0), layer.denominators.at(1))]
        return GkrMask(cols)


def correct_sum_as_poly_in_first_variable(f_at_0: QM31, f_at_2: QM31,
                                          claim: QM31, y: List[QM31],
                                          k: int) -> UnivariatePoly:
    """r(t) correction (reference gkr_prover.ts:609-670; ia.cr/2024/108 s3.2)."""
    if k == 0:
        raise ValueError("k must not be 0")
    n = len(y)
    if k > n:
        raise ValueError("k must not exceed len(y)")
    zeros = [QM31.zero()] * (n - k + 1)
    a_const = eq(zeros, y[: n - k + 1]).inverse()
    y_nk = y[n - k]
    b_const = (QM31.one() - y_nk).div(QM31.one() - y_nk.double())
    r_at_0 = f_at_0 * eq([QM31.zero()], [y_nk]) * a_const
    r_at_1 = claim - r_at_0
    r_at_2 = f_at_2 * eq([QM31.from_base(M31(2))], [y_nk]) * a_const
    r_at_b = QM31.zero()
    two = QM31.from_base(M31(2))
    return UnivariatePoly.interpolate_lagrange(
        [QM31.zero(), QM31.one(), two, b_const],
        [r_at_0, r_at_1, r_at_2, r_at_b])


# ---------------------------------------------------------------------------
# Batch prover / verifier
# ---------------------------------------------------------------------------

@dataclass
class GkrBatchProof:
    sumcheck_proofs: List[SumcheckProof]
    layer_masks_by_instance: List[List[GkrMask]]
    output_claims_by_instance: List[List[QM31]]


@dataclass
class GkrArtifact:
    ood_point: List[QM31]
    claims_to_verify_by_instance: List[List[QM31]]
    n_variables_by_instance: List[int]


def prove_batch(channel, input_layer_by_instance: List[Layer]
                ) -> Tuple[GkrBatchProof, GkrArtifact]:
    """reference gkr_prover.ts:440-580.  Every input layer lives on one
    device, where the eq tables are built too.  Spans `gkr_layers` (the
    circuits), `gkr_eq_evals` and `gkr_sumcheck` (each layer's); counter
    `gkr_instances`."""
    n_instances = len(input_layer_by_instance)
    n_layers_by_instance = [l.n_variables() for l in input_layer_by_instance]
    n_layers = max(n_layers_by_instance)
    device = input_layer_by_instance[0].device()
    count("gkr_instances", n_instances)

    layers_by_instance = []
    with span("gkr_layers"):
        for input_layer in input_layer_by_instance:
            layers = _gen_layers(input_layer)
            layers.reverse()
            layers_by_instance.append(iter(layers))

    output_claims: List[Optional[List[QM31]]] = [None] * n_instances
    layer_masks: List[List[GkrMask]] = [[] for _ in range(n_instances)]
    sumcheck_proofs: List[SumcheckProof] = []
    ood_point: List[QM31] = []
    claims_to_verify: List[Optional[List[QM31]]] = [None] * n_instances

    for layer_idx in range(n_layers):
        n_remaining = n_layers - layer_idx
        for inst in range(n_instances):
            if n_layers_by_instance[inst] == n_remaining:
                output_layer = next(layers_by_instance[inst])
                values = output_layer.try_into_output_layer_values()
                claims_to_verify[inst] = list(values)
                output_claims[inst] = values
        for claims in claims_to_verify:
            if claims is not None:
                channel.mix_felts(claims)
        with span("gkr_eq_evals"):
            eq_evals = EqEvals.generate(ood_point, device)
        sumcheck_alpha = channel.draw_felt()
        instance_lambda = channel.draw_felt()

        sumcheck_oracles = []
        sumcheck_claims = []
        sumcheck_instances = []
        for inst in range(n_instances):
            claims = claims_to_verify[inst]
            if claims is not None:
                layer = next(layers_by_instance[inst])
                sumcheck_oracles.append(
                    layer.into_multivariate_poly(instance_lambda, eq_evals))
                sumcheck_claims.append(
                    random_linear_combination(claims, instance_lambda))
                sumcheck_instances.append(inst)

        with span("gkr_sumcheck"):
            proof, sumcheck_ood_point, constant_oracles, _ = \
                sumcheck_prove_batch(sumcheck_claims, sumcheck_oracles,
                                     sumcheck_alpha, channel)
        sumcheck_proofs.append(proof)
        masks = [o.try_into_mask() for o in constant_oracles]
        for inst, mask in zip(sumcheck_instances, masks):
            flat = [v for col in mask.columns() for v in col]
            channel.mix_felts(flat)
            layer_masks[inst].append(mask)
        challenge = channel.draw_felt()
        ood_point = list(sumcheck_ood_point) + [challenge]
        for inst, mask in zip(sumcheck_instances, masks):
            claims_to_verify[inst] = mask.reduce_at_point(challenge)

    proof = GkrBatchProof(sumcheck_proofs, layer_masks,
                          [c for c in output_claims])
    artifact = GkrArtifact(ood_point, [c for c in claims_to_verify],
                           n_layers_by_instance)
    return proof, artifact


def _gen_layers(input_layer: Layer) -> List[Layer]:
    """All circuit layers, input first: one halving step per layer.  The
    counter `gkr_layer_points` adds the points of each layer made (2^n - 1
    for an input of 2^n points)."""
    layers = [input_layer]
    while not layers[-1].is_output_layer():
        layers.append(layers[-1].next_layer())
        count("gkr_layer_points", 1 << layers[-1].n_variables())
    return layers


GATE_GRAND_PRODUCT = "GrandProduct"
GATE_LOGUP = "LogUp"


def _evaluate_gate(gate: str, mask: GkrMask) -> List[QM31]:
    if gate == GATE_LOGUP:
        if len(mask.columns()) != 2:
            raise GkrError("mask has an invalid number of columns")
        (na, nb), (da, db) = mask.columns()
        res = Fraction(na, da) + Fraction(nb, db)
        return [res.numerator, res.denominator]
    if gate == GATE_GRAND_PRODUCT:
        if len(mask.columns()) != 1:
            raise GkrError("mask has an invalid number of columns")
        a, b = mask.columns()[0]
        return [a * b]
    raise GkrError(f"unknown gate {gate}")


def partially_verify_batch(gate_by_instance: List[str], proof: GkrBatchProof,
                           channel) -> GkrArtifact:
    """reference gkr_verifier.ts:14-166."""
    if len(proof.layer_masks_by_instance) != len(proof.output_claims_by_instance):
        raise GkrError("proof data is invalid")
    n_instances = len(proof.layer_masks_by_instance)
    inst_n_layers = lambda i: len(proof.layer_masks_by_instance[i])  # noqa: E731
    n_layers = max(inst_n_layers(i) for i in range(n_instances))
    if n_layers != len(proof.sumcheck_proofs):
        raise GkrError("proof data is invalid")
    if len(gate_by_instance) != n_instances:
        raise GkrError("invalid number of instances")

    ood_point: List[QM31] = []
    claims_to_verify: List[Optional[List[QM31]]] = [None] * n_instances

    for layer_idx, sumcheck_proof in enumerate(proof.sumcheck_proofs):
        n_remaining = n_layers - layer_idx
        for inst in range(n_instances):
            if inst_n_layers(inst) == n_remaining:
                claims_to_verify[inst] = list(
                    proof.output_claims_by_instance[inst])
        for claims in claims_to_verify:
            if claims is not None:
                channel.mix_felts(claims)
        sumcheck_alpha = channel.draw_felt()
        instance_lambda = channel.draw_felt()
        sumcheck_claims = []
        sumcheck_instances = []
        for inst in range(n_instances):
            claims = claims_to_verify[inst]
            if claims is not None:
                n_unused = n_layers - inst_n_layers(inst)
                claim = random_linear_combination(
                    claims, instance_lambda).mul_m31(M31.from_int(1 << n_unused))
                sumcheck_claims.append(claim)
                sumcheck_instances.append(inst)
        sumcheck_claim = random_linear_combination(sumcheck_claims,
                                                   sumcheck_alpha)
        try:
            sumcheck_ood_point, sumcheck_eval = sumcheck_verify(
                sumcheck_claim, sumcheck_proof, channel)
        except Exception as e:
            raise GkrError(f"sum-check invalid in layer {layer_idx}: {e}")
        layer_evals = []
        for inst in sumcheck_instances:
            n_unused = n_layers - inst_n_layers(inst)
            mask = proof.layer_masks_by_instance[inst][layer_idx - n_unused]
            gate_output = _evaluate_gate(gate_by_instance[inst], mask)
            eq_eval = eq(ood_point[n_unused:], sumcheck_ood_point[n_unused:])
            layer_evals.append(
                eq_eval * random_linear_combination(gate_output,
                                                    instance_lambda))
        layer_eval = random_linear_combination(layer_evals, sumcheck_alpha)
        if sumcheck_eval != layer_eval:
            raise GkrError(
                f"circuit check failed in layer {layer_idx} "
                f"(calculated {layer_eval}, claim {sumcheck_eval})")
        for inst in sumcheck_instances:
            n_unused = n_layers - inst_n_layers(inst)
            mask = proof.layer_masks_by_instance[inst][layer_idx - n_unused]
            flat = [v for col in mask.columns() for v in col]
            channel.mix_felts(flat)
        challenge = channel.draw_felt()
        ood_point = list(sumcheck_ood_point) + [challenge]
        for inst in sumcheck_instances:
            n_unused = n_layers - inst_n_layers(inst)
            mask = proof.layer_masks_by_instance[inst][layer_idx - n_unused]
            claims_to_verify[inst] = mask.reduce_at_point(challenge)

    return GkrArtifact(ood_point, [c for c in claims_to_verify],
                       [inst_n_layers(i) for i in range(n_instances)])
