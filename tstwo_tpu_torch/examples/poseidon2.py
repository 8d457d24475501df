"""Poseidon2 AIR with a LogUp relation (stwo's examples/poseidon).

Each row proves N_INSTANCES_PER_ROW = 8 Poseidon2 permutations of a
16-element M31 state.  Instance k owns columns [158k, 158k + 158): the 16
input-state columns, 16 after each of full rounds 0-3, one (the state's
first element) after each of the 14 partial rounds, 16 after each of full
rounds 4-7.  A round's constraints tie the S-box output, computed from the
previous committed state, to the round's columns: 142 constraints of
degree 5 an instance.

The round structure, matrices and constants are those of stwo's example:
every round constant is 1234 (its placeholders), the internal matrix adds
the state's sum to s_i * 2^(i+1), and the matrix is applied before the
S-box.  They are not the HorizenLabs M31 instance's.

LogUp: each instance adds (+1, input state) and (-1, output state) to a
relation of width 16 (`combine(v) = sum_i alpha^i v_i - z`);
`finalize_logup_in_pairs` makes each instance's pair one batch, so the
interaction trace has 8 secure columns, the last one prefix-summed with
the cumsum shift.  The claimed sum is not zero: the relation's other side
lives in another component of a deployment.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..channel.blake2s import Blake2sChannel
from ..circle import CanonicCoset
from ..constraint_framework import (FrameworkComponent, FrameworkEval,
                                    TraceLocationAllocator)
from ..constraint_framework.logup import (LogupTraceGenerator, LookupElements,
                                          RelationEntry)
from ..fields import M31, QM31
from ..pcs import PcsConfig
from ..pcs.prover import CommitmentSchemeProver
from ..pcs.utils import TreeVec
from ..pcs.verifier import CommitmentSchemeVerifier
from ..poly.circle_poly import CircleEvaluation
from ..poly.twiddles import twiddles_for
from ..prover import StarkProof, prove, verify
from ..utils import entry_device

P = (1 << 31) - 1
N_STATE = 16
N_INSTANCES_PER_ROW = 8
N_HALF_FULL_ROUNDS = 4
N_PARTIAL_ROUNDS = 14
LOG_EXPAND = 2  # degree-5 constraints: the composition on 4x the rows
COLUMNS_PER_INSTANCE = N_STATE * (1 + 2 * N_HALF_FULL_ROUNDS) + N_PARTIAL_ROUNDS
N_COLUMNS = COLUMNS_PER_INSTANCE * N_INSTANCES_PER_ROW
# stwo's example placeholders
EXTERNAL_ROUND_CONSTS = [[1234] * N_STATE] * (2 * N_HALF_FULL_ROUNDS)
INTERNAL_ROUND_CONSTS = [1234] * N_PARTIAL_ROUNDS
INTERNAL_DIAGONAL = [1 << (i + 1) for i in range(N_STATE)]


def _apply_m4(x):
    t0 = x[0] + x[1]
    t02 = t0 + t0
    t1 = x[2] + x[3]
    t12 = t1 + t1
    t2 = x[1] + x[1] + t1
    t3 = x[3] + x[3] + t0
    t4 = t12 + t12 + t3
    t5 = t02 + t02 + t2
    t6 = t3 + t5
    t7 = t2 + t4
    return [t6, t5, t7, t4]


def apply_external_round_matrix(state: list) -> list:
    """circ(2 M4, M4, M4, M4) on 16 values of an evaluator (or int64
    tensors, reduced by the caller)."""
    state = list(state)
    for c in range(4):
        state[4 * c:4 * c + 4] = _apply_m4(state[4 * c:4 * c + 4])
    for j in range(4):
        s = state[j] + state[j + 4] + state[j + 8] + state[j + 12]
        for c in range(4):
            state[4 * c + j] = state[4 * c + j] + s
    return state


def apply_internal_round_matrix(state: list) -> list:
    total = state[0]
    for s in state[1:]:
        total = total + s
    return [s * M31(d) + total for s, d in zip(state, INTERNAL_DIAGONAL)]


def pow5(x):
    return x.square().square() * x


class Poseidon2Eval(FrameworkEval):
    """The AIR of 2^log_n_rows rows of 8 permutations each."""

    def __init__(self, log_n_rows: int, lookup_elements: LookupElements):
        self.log_n_rows = log_n_rows
        self.lookup_elements = lookup_elements

    def log_size(self) -> int:
        return self.log_n_rows

    def max_constraint_log_degree_bound(self) -> int:
        return self.log_n_rows + LOG_EXPAND

    def kernel_cache_key(self):
        return (self.log_n_rows, len(self.lookup_elements.alpha_powers))

    def evaluate(self, ev):
        for _ in range(N_INSTANCES_PER_ROW):
            state = [ev.next_trace_mask() for _ in range(N_STATE)]
            ev.add_to_relation(
                RelationEntry(self.lookup_elements, QM31.one(), state))
            for rnd in range(N_HALF_FULL_ROUNDS):
                state = self._full_round(ev, state, rnd)
            for rnd in range(N_PARTIAL_ROUNDS):
                state[0] = state[0] + M31(INTERNAL_ROUND_CONSTS[rnd])
                state = apply_internal_round_matrix(state)
                m = ev.next_trace_mask()
                ev.add_constraint(pow5(state[0]) - m)
                state[0] = m
            for rnd in range(N_HALF_FULL_ROUNDS):
                state = self._full_round(ev, state, rnd + N_HALF_FULL_ROUNDS)
            ev.add_to_relation(
                RelationEntry(self.lookup_elements, -QM31.one(), state))
        ev.finalize_logup_in_pairs()
        return ev

    @staticmethod
    def _full_round(ev, state, rnd):
        state = [s + M31(c) for s, c in zip(state, EXTERNAL_ROUND_CONSTS[rnd])]
        state = apply_external_round_matrix(state)
        out = []
        for s in state:
            m = ev.next_trace_mask()
            ev.add_constraint(pow5(s) - m)
            out.append(m)
        return out


# -- the trace, on the device -------------------------------------------------

def _pow5_w(x):
    x2 = x * x % P
    return x2 * x2 % P * x % P


def _external_w(s):
    """[16, ...] int64 -> M_E s, canonical."""
    y = torch.stack(_apply_m4(list(s.reshape(4, 4, *s.shape[1:]).transpose(
        0, 1)))).transpose(0, 1)  # [4 chunks, 4, ...]
    return ((y + y.sum(dim=0, keepdim=True)) % P).reshape(s.shape)


def permutation_columns(inputs: torch.Tensor) -> torch.Tensor:
    """Inputs int64 [8, 16, n] (canonical) -> the trace, int32 [8 * 158, n]:
    the columns of every round of every instance, instance-major."""
    s = inputs.transpose(0, 1)  # [16, 8, n]
    diag = torch.tensor(INTERNAL_DIAGONAL, dtype=torch.int64,
                        device=inputs.device).view(N_STATE, 1, 1)
    cols = [s.to(torch.int32)]

    def full(s, rnd):
        const = torch.tensor(EXTERNAL_ROUND_CONSTS[rnd], dtype=torch.int64,
                             device=s.device).view(N_STATE, 1, 1)
        s = _pow5_w(_external_w((s + const) % P))
        cols.append(s.to(torch.int32))
        return s

    for rnd in range(N_HALF_FULL_ROUNDS):
        s = full(s, rnd)
    for rnd in range(N_PARTIAL_ROUNDS):
        s = s.clone()
        s[0] = (s[0] + INTERNAL_ROUND_CONSTS[rnd]) % P
        s = (s * diag + s.sum(dim=0, keepdim=True)) % P
        s[0] = _pow5_w(s[0])
        cols.append(s[:1].to(torch.int32))
    for rnd in range(N_HALF_FULL_ROUNDS):
        s = full(s, rnd + N_HALF_FULL_ROUNDS)
    # [158, 8, n] -> [8, 158, n]
    return torch.cat(cols).transpose(0, 1).reshape(N_COLUMNS, -1)


def trace_inputs(log_n_rows: int, seed: int, device) -> torch.Tensor:
    """The input states, int64 [8, 16, 2^log_n_rows] (canonical) on
    `device`, made from `seed` (an int >= 0) by a counter-based map: with
    a = seed mod P, b = 1 + (seed div P) mod (P - 1) and
    c = (seed div (P (P - 1))) mod P, element i of the row-major order is
    y_3, where y_0 = i b + a and y_(k+1) = (y_k + c + k)^5, all mod P.
    Each step is a bijection of M31 (gcd(5, P - 1) = 1), so the states of
    one proof are distinct."""
    a = seed % P
    b = 1 + seed // P % (P - 1)
    c = seed // (P * (P - 1)) % P
    n = N_INSTANCES_PER_ROW * N_STATE << log_n_rows
    y = (torch.arange(n, dtype=torch.int64, device=device) * b + a) % P
    for k in range(3):
        y = _pow5_w((y + (c + k) % P) % P)
    return y.reshape(N_INSTANCES_PER_ROW, N_STATE, 1 << log_n_rows)


def generate_trace(log_n_rows: int, seed: int = 0,
                   device=None) -> List[torch.Tensor]:
    """The 1264 columns of 2^log_n_rows rows, inputs (`trace_inputs`) and
    permutations computed on `device` (CUDA device 0 unless given; "cpu"
    for the CPU)."""
    device = entry_device(device)
    return list(permutation_columns(trace_inputs(log_n_rows, seed, device)))


def generate_interaction_trace(log_n_rows: int, columns, lookup_elements:
                               LookupElements):
    """The interaction columns (4 base coordinates for each of the 8
    secure columns) and the claimed sum, on the trace's device: instance
    k's pair 1/combine(input) - 1/combine(output) is batch k."""
    gen = LogupTraceGenerator(log_n_rows, columns[0].device)
    for k in range(N_INSTANCES_PER_ROW):
        base = k * COLUMNS_PER_INSTANCE
        col = gen.new_col()
        col.write_frac(QM31.one(), lookup_elements.combine_cols(
            columns[base:base + N_STATE]))
        col.write_frac(-QM31.one(), lookup_elements.combine_cols(
            columns[base + COLUMNS_PER_INSTANCE - N_STATE:
                    base + COLUMNS_PER_INSTANCE]))
        col.finalize_col()
    return gen.finalize_last()


def prove_poseidon2(log_n_rows: int = 6, config: PcsConfig = None,
                    seed: int = 0, device=None, trace=None
                    ) -> Tuple[StarkProof, PcsConfig, QM31]:
    """Prove 2^log_n_rows rows (8 permutations each) on `device`: CUDA
    device 0 unless given; `device="cpu"` runs the plain PyTorch versions
    on the CPU.  `trace` is an optional list of the 1264 int32 columns to
    prove instead of generate_trace's.  Returns the proof, the config and
    the claimed sum."""
    from ..tracing import span

    device = entry_device(device)
    config = config or PcsConfig()
    with span("trace_gen"):
        columns = ([t.to(device) for t in trace] if trace is not None
                   else generate_trace(log_n_rows, seed, device))
        domain = CanonicCoset.new(log_n_rows).circle_domain()
    with span("twiddle_precompute"):
        twiddles = twiddles_for(
            [Poseidon2Eval(log_n_rows, LookupElements.dummy(N_STATE))],
            config.fri_config.log_blowup_factor)
    channel = Blake2sChannel()
    scheme = CommitmentSchemeProver(config, twiddles, device)
    tb = scheme.tree_builder()
    tb.extend_evals([])
    tb.commit(channel)
    channel.mix_u64(log_n_rows)
    tb = scheme.tree_builder()
    tb.extend_evals([CircleEvaluation(domain, c) for c in columns])
    tb.commit(channel)

    lookup_elements = LookupElements.draw(channel, N_STATE)
    interaction, claimed_sum = generate_interaction_trace(
        log_n_rows, columns, lookup_elements)
    tb = scheme.tree_builder()
    tb.extend_evals(interaction)
    tb.commit(channel)

    with span("component_setup"):
        component = FrameworkComponent(
            TraceLocationAllocator(),
            Poseidon2Eval(log_n_rows, lookup_elements), claimed_sum)
    proof = prove([component], channel, scheme)
    return proof, config, claimed_sum


def verify_poseidon2(proof: StarkProof, config: PcsConfig, log_n_rows: int,
                     claimed_sum: QM31) -> None:
    """Replays the transcript: the verifier draws the lookup elements at
    the same position and checks the component with the claimed sum."""
    sizes = TreeVec([[], [log_n_rows] * N_COLUMNS,
                     [log_n_rows] * (4 * N_INSTANCES_PER_ROW)])
    channel = Blake2sChannel()
    scheme = CommitmentSchemeVerifier(config)
    scheme.commit(proof.commitments[0], sizes[0], channel)
    channel.mix_u64(log_n_rows)
    scheme.commit(proof.commitments[1], sizes[1], channel)
    lookup_elements = LookupElements.draw(channel, N_STATE)
    scheme.commit(proof.commitments[2], sizes[2], channel)
    component = FrameworkComponent(
        TraceLocationAllocator(), Poseidon2Eval(log_n_rows, lookup_elements),
        claimed_sum)
    verify([component], channel, scheme, proof)
