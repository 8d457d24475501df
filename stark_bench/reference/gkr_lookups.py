"""The plain reference of a GKR batch proof of lookups: a GrandProduct and
a LogUpGeneric instance proved in one batch, as stwo's
`core/lookups/gkr_prover.rs` `prove_batch` (with `sumcheck.rs`, `mle.rs`
and `utils.rs`) defines it.

Plain PyTorch in int64 `% P` on any device, and the standard library: a
QM31 vector is int64 [4, n] (coordinates a, b, c, d of (a + b i) +
(c + d i) u, u^2 = 2 + i), a scalar a 4-tuple of ints (`algebra`), and the
Fiat-Shamir channel is `hashes.Blake2sChannel`.  An MLE over {0,1}^n is
its 2^n values, the first variable the most significant bit of the index.

A circuit halves its input once per layer: a grand product takes the
products v(x, 0) v(x, 1) of each pair, a LogUp sum the fraction sums
n0/d0 + n1/d1 = (n0 d1 + n1 d0) / (d0 d1).  The proof runs from the
output layer down: each layer's claims are reduced by one batched
sum-check over its instances (weights alpha^i, each instance's claims
combined by lambda) of eq(x, r) gate(layer(x, 0), layer(x, 1)), whose
round polynomial is built from its sums at 0 and 2 and the eq correction
of ia.cr/2024/108 s3.2; the mask, the layer's two values at the last
point, is mixed in, and a fresh challenge extends the point.  An instance
of fewer layers joins the batch late, its claim doubled for each unused
variable.  The proof is its three fields as plain data, a QM31 as 4 ints.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .algebra import P, QM31, Ops, q, q_add, q_inv, q_mul, q_sub, vpow
from .hashes import Blake2sChannel

GRAND_PRODUCT = "GrandProduct"
LOGUP_GENERIC = "LogUpGeneric"
CHANNELS = {"blake2s": Blake2sChannel}
ZERO, ONE, TWO = q(0), q(1), q(2)

Instance = Tuple[str, Tuple[torch.Tensor, ...]]  # kind, its columns


# -- QM31 vectors [4, n] -------------------------------------------------------

def _cm(a0, a1, b0, b1):
    """(a0 + a1 i)(b0 + b1 i), each product reduced at once."""
    return ((a0 * b0 % P - a1 * b1 % P) % P, (a0 * b1 % P + a1 * b0 % P) % P)


def qv_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x0 + x1 u)(y0 + y1 u) = x0 y0 + (2 + i) x1 y1 + (x0 y1 + x1 y0) u."""
    lo = _cm(x[0], x[1], y[0], y[1])
    hh = _cm(x[2], x[3], y[2], y[3])
    hh = _cm(hh[0], hh[1], 2, 1)
    m0 = _cm(x[0], x[1], y[2], y[3])
    m1 = _cm(x[2], x[3], y[0], y[1])
    return torch.stack([(lo[0] + hh[0]) % P, (lo[1] + hh[1]) % P,
                        (m0[0] + m1[0]) % P, (m0[1] + m1[1]) % P])


def qv_add(x, y):
    return (x + y) % P


def qv_sub(x, y):
    return (x - y) % P


def vec(s: QM31, device) -> torch.Tensor:
    """A scalar as a [4, 1] vector."""
    return torch.tensor(s, dtype=torch.int64, device=device).reshape(4, 1)


def total(x: torch.Tensor) -> torch.Tensor:
    """The sum of a vector's values, [4]: fewer than 2^32 values below P
    add up inside int64."""
    return x.sum(dim=1) % P


def at(x: torch.Tensor, i: int) -> QM31:
    return tuple(int(v) for v in x[:, i].tolist())


# -- scalars -------------------------------------------------------------------

def q_div(x: QM31, y: QM31) -> QM31:
    return q_mul(x, q_inv(y))


def eq1(x: QM31, y: QM31) -> QM31:
    """eq of one coordinate: x y + (1 - x)(1 - y)."""
    return q_add(q_mul(x, y), q_mul(q_sub(ONE, x), q_sub(ONE, y)))


def horner(values: Sequence[QM31], alpha: QM31) -> QM31:
    """values[0] + alpha values[1] + alpha^2 values[2] + ..."""
    acc = ZERO
    for v in reversed(values):
        acc = q_add(q_mul(acc, alpha), v)
    return acc


def trimmed(coeffs: List[QM31]) -> List[QM31]:
    """Without its zero coefficients of highest degree, as stwo's
    UnivariatePoly holds a polynomial."""
    coeffs = list(coeffs)
    while coeffs and coeffs[-1] == ZERO:
        coeffs.pop()
    return coeffs


def round_poly(f0: QM31, f2: QM31, claim: QM31, y: Sequence[QM31],
               k: int) -> List[QM31]:
    """The round polynomial r(t) = f(t) eq(t, y[n-k]) / eq(0, y[:n-k+1]) of
    a sum-check whose oracle has k variables left, from f's sums f0 and f2
    at t = 0 and t = 2 (ia.cr/2024/108 s3.2).  r has degree 3: its root b,
    where eq(t, y[n-k]) = 0, r(0), r(2), and r(1) = claim - r(0) fix it.
    Written as (t - b) (c0 + c1 t + c2 t^2), the quadratic through
    r(t) / (t - b) at t = 0, 1, 2."""
    n = len(y)
    z = y[n - k]
    scale = ONE
    for yj in y[:n - k + 1]:
        scale = q_mul(scale, q_sub(ONE, yj))
    scale = q_inv(scale)
    b = q_div(q_sub(ONE, z), q_sub(ONE, q_add(z, z)))
    r0 = q_mul(q_mul(f0, eq1(ZERO, z)), scale)
    r1 = q_sub(claim, r0)
    r2 = q_mul(q_mul(f2, eq1(TWO, z)), scale)
    g0 = q_div(r0, q_sub(ZERO, b))
    g1 = q_div(r1, q_sub(ONE, b))
    g2 = q_div(r2, q_sub(TWO, b))
    c2 = q_div(q_add(q_sub(g2, q_add(g1, g1)), g0), TWO)
    c1 = q_sub(q_sub(g1, g0), c2)
    c0 = g0
    neg_b = q_sub(ZERO, b)
    return trimmed([q_mul(neg_b, c0), q_add(c0, q_mul(neg_b, c1)),
                    q_add(c1, q_mul(neg_b, c2)), c2])


# -- circuits ------------------------------------------------------------------

def next_layer(kind: str, cols: Tuple[torch.Tensor, ...]):
    """The layer above: each pair (2j, 2j + 1) of the layer combined."""
    if kind == GRAND_PRODUCT:
        (v,) = cols
        return (qv_mul(v[:, 0::2], v[:, 1::2]),)
    num, den = cols
    n0, n1, d0, d1 = num[:, 0::2], num[:, 1::2], den[:, 0::2], den[:, 1::2]
    return (qv_add(qv_mul(n0, d1), qv_mul(n1, d0)), qv_mul(d0, d1))


def circuit(kind: str, cols) -> list:
    """Every layer, the input first and the one-point output last."""
    layers = [tuple(cols)]
    while layers[-1][0].shape[1] > 1:
        layers.append(next_layer(kind, layers[-1]))
    return layers


def gate_terms(kind: str, a: Sequence[torch.Tensor],
               b: Sequence[torch.Tensor], lam: QM31) -> torch.Tensor:
    """The gate of the pair (a, b), its claims combined by lambda: the
    product a b, or the fraction sum's numerator + lambda its denominator."""
    if kind == GRAND_PRODUCT:
        return qv_mul(a[0], b[0])
    (na, da), (nb, db) = a, b
    numer = qv_add(qv_mul(na, db), qv_mul(nb, da))
    return qv_add(numer, qv_mul(vec(lam, numer.device), qv_mul(da, db)))


def eq_table(y: Sequence[QM31], device) -> torch.Tensor:
    """eq((0, x), y) for x in {0,1}^(len(y) - 1), [4, 2^(len(y) - 1)],
    y[1] on the most significant bit; [1] for an empty y."""
    if not y:
        return vec(ONE, device)
    table = vec(q_sub(ONE, y[0]), device)
    for yj in y[1:]:
        lo = qv_mul(table, vec(q_sub(ONE, yj), device))
        hi = qv_mul(table, vec(yj, device))
        table = torch.stack([lo, hi], dim=2).reshape(4, -1)
    return table


class Oracle:
    """The sum-check polynomial of one instance's layer: x ranges over
    the layer's variables but its last, and the polynomial is
    eq(x, y) gate(layer(x, 0), layer(x, 1)) with claims combined by
    lambda; `correction` is eq's factor of the variables already fixed."""

    def __init__(self, kind: str, cols, y: Sequence[QM31],
                 table: torch.Tensor, lam: QM31):
        self.kind, self.cols, self.y, self.table = kind, cols, y, table
        self.lam, self.correction = lam, ONE

    def n_variables(self) -> int:
        return self.cols[0].shape[1].bit_length() - 2

    def round(self, claim: QM31) -> List[QM31]:
        k = self.n_variables()
        half = 1 << (k - 1)
        eq_part = self.table[:, :half]

        def quarters(c):
            return (c[:, 0:2 * half:2], c[:, 1:2 * half:2],
                    c[:, 2 * half::2], c[:, 2 * half + 1::2])

        q0a, q0b, q1a, q1b = zip(*(quarters(c) for c in self.cols))
        q2a = [qv_sub(qv_add(u, u), v) for u, v in zip(q1a, q0a)]
        q2b = [qv_sub(qv_add(u, u), v) for u, v in zip(q1b, q0b)]
        sums = torch.stack([
            total(qv_mul(eq_part, gate_terms(self.kind, q0a, q0b, self.lam))),
            total(qv_mul(eq_part, gate_terms(self.kind, q2a, q2b, self.lam))),
        ]).tolist()
        f0 = q_mul(tuple(sums[0]), self.correction)
        f2 = q_mul(tuple(sums[1]), self.correction)
        return round_poly(f0, f2, claim, self.y, k)

    def fix(self, r: QM31) -> None:
        """Fix the first variable to r: each column folded by halves."""
        z = self.y[len(self.y) - self.n_variables()]
        self.correction = q_mul(self.correction, eq1(r, z))
        rv = vec(r, self.cols[0].device)
        folded = []
        for c in self.cols:
            mid = c.shape[1] // 2
            lo, hi = c[:, :mid], c[:, mid:]
            folded.append(qv_add(lo, qv_mul(rv, qv_sub(hi, lo))))
        self.cols = tuple(folded)

    def mask(self) -> List[Tuple[QM31, QM31]]:
        return [(at(c, 0), at(c, 1)) for c in self.cols]


def sumcheck(claims: List[QM31], oracles: List[Oracle], alpha: QM31,
             channel) -> Tuple[List[List[QM31]], List[QM31]]:
    """The batched sum-check of sum_i alpha^i oracle_i: its round
    polynomials and the point its challenges make."""
    n = max(o.n_variables() for o in oracles)
    claims = [q_mul(c, q(1 << (n - o.n_variables())))
              for c, o in zip(claims, oracles)]
    half = q_inv(TWO)
    polys, point = [], []
    for r in range(n):
        left = n - r
        each = [o.round(c) if o.n_variables() == left else
                trimmed([q_mul(c, half)]) for o, c in zip(oracles, claims)]
        for poly, c in zip(each, claims):
            if q_add(horner(poly, ZERO), horner(poly, ONE)) != c:
                raise ArithmeticError(f"round {r}: r(0) + r(1) != claim")
        combined = []
        for poly in reversed(each):
            combined = [q_mul(c, alpha) for c in combined]
            combined += [ZERO] * (len(poly) - len(combined))
            combined = [q_add(a, poly[i]) if i < len(poly) else a
                        for i, a in enumerate(combined)]
        combined = trimmed(combined)
        channel.mix_felts(combined)
        challenge = channel.draw_felt()
        claims = [horner(poly, challenge) for poly in each]
        for o in oracles:
            if o.n_variables() == left:
                o.fix(challenge)
        polys.append(combined)
        point.append(challenge)
    return polys, point


def _ints(v: QM31) -> List[int]:
    return [int(x) for x in v]


def batch_proof(channel, instances: Sequence[Instance], device
                ) -> Tuple[Dict[str, list], List[QM31], List[List[QM31]]]:
    """The batch proof of `instances` as plain data, with the point it
    ends at and each instance's claims to verify there (on the last
    n_layers(instance) coordinates of the point)."""
    circuits = [circuit(kind, [c.to(device) for c in cols])
                for kind, cols in instances]
    n_layers = [len(c) - 1 for c in circuits]
    depth = max(n_layers)
    outputs: List[List[QM31]] = [None] * len(instances)
    claims: List[List[QM31]] = [None] * len(instances)
    masks: List[list] = [[] for _ in instances]
    rounds: List[list] = []
    point: List[QM31] = []
    for layer in range(depth):
        for i, c in enumerate(circuits):
            if n_layers[i] == depth - layer:
                outputs[i] = claims[i] = [at(col, 0) for col in c[-1]]
        for cl in claims:
            if cl is not None:
                channel.mix_felts(cl)
        table = eq_table(point, device)
        alpha = channel.draw_felt()
        lam = channel.draw_felt()
        active = [i for i, cl in enumerate(claims) if cl is not None]
        oracles = []
        for i in active:
            # the instance's own step s proves its layer of s + 1 variables
            s = layer - (depth - n_layers[i])
            oracles.append(Oracle(instances[i][0],
                                  circuits[i][n_layers[i] - 1 - s], point,
                                  table, lam))
        polys, sc_point = sumcheck([horner(claims[i], lam) for i in active],
                                   oracles, alpha, channel)
        rounds.append([[_ints(c) for c in p] for p in polys])
        layer_masks = [o.mask() for o in oracles]
        for i, m in zip(active, layer_masks):
            channel.mix_felts([v for pair in m for v in pair])
            masks[i].append([[_ints(a), _ints(b)] for a, b in m])
        challenge = channel.draw_felt()
        point = sc_point + [challenge]
        for i, m in zip(active, layer_masks):
            claims[i] = [q_add(a, q_mul(challenge, q_sub(b, a)))
                         for a, b in m]
    proof = {"sumcheck_proofs": rounds, "layer_masks_by_instance": masks,
             "output_claims_by_instance": [[_ints(v) for v in out]
                                           for out in outputs]}
    return proof, point, claims


# -- the cell's interface ------------------------------------------------------

def trace_inputs(trace_seed: int, log_n: int) -> torch.Tensor:
    """int64 [3, 4, 2^log_n]: the GrandProduct values, the LogUp numerators
    and denominators.  Element i (row-major) is 1 + (y_3 mod (P - 1)) of
    y_0 = i b + a, y_(k+1) = (y_k + c + k)^5 mod P, where a, b, c are the
    seed's digits: a = seed mod P, b = 1 + (seed div P) mod (P - 1),
    c = (seed div (P (P - 1))) mod P."""
    a = trace_seed % P
    b = 1 + (trace_seed // P) % (P - 1)
    c = trace_seed // (P * (P - 1)) % P
    y = (torch.arange(3 * 4 << log_n, dtype=torch.int64) * b + a) % P
    for k in range(3):
        y = vpow(Ops.add(y, (c + k) % P), 5)
    return (y % (P - 1) + 1).reshape(3, 4, 1 << log_n)


def _instances(inputs: torch.Tensor) -> List[Instance]:
    return [(GRAND_PRODUCT, (inputs[0],)),
            (LOGUP_GENERIC, (inputs[1], inputs[2]))]


def prove(inputs: torch.Tensor, config: dict, log_n: int, device) -> dict:
    """The batch proof of the configuration's two instances."""
    if inputs.shape[-1] != 1 << log_n:
        raise ValueError(f"inputs of {inputs.shape[-1]} points, not 2^{log_n}")
    channel = CHANNELS[config["channel"]]()
    return batch_proof(channel, _instances(inputs), device)[0]


def control(inputs: torch.Tensor, config: dict, log_n: int, device):
    """The proof of the same inputs but one GrandProduct value, which
    changes the product's output claim and so the whole transcript after
    it: every part differs from the sound proof."""
    changed = inputs.clone()
    changed[0, 0, 0] = changed[0, 0, 0] % (P - 1) + 1
    return ("one GrandProduct value changed",
            prove(changed, config, log_n, device))
