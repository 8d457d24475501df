"""A whole run of a tiny cell, past the harness's look for a chip, with the
timed path sound and then broken underneath: the comparison must refuse
each fault a closed loop of proofs can have.

The card-only case runs the same tiny cell on the card; it skips without
one (`python -m pytest stark_bench/tests -m cuda` on the card)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench_fixtures import tiny_checkout
from stark_bench import registry, run
from stark_bench.compare import PARTS


def _run(root, device="cpu", seconds=1.0):
    return run.run_cell(root, registry.load(root), "tiny.cell", 2 ** 31 + 9,
                        seconds, False, torch.device(device), t0=0.0)


def test_a_sound_run_is_correct(tmp_path):
    result = _run(tiny_checkout(tmp_path))
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["proofs_compared"]["value"] == 2
    assert list(result["checks"])[-1] == "proofs_compared"
    assert set(result["metrics"]) == {"setup_s", "prove_s", "peak_mem_gib"}


def _altered(proof, _state, _args):
    """An answer altered where it is produced: one queried value."""
    from tstwo_tpu_torch.fields import M31

    values = proof.commitment_scheme_proof.queried_values[1]
    values[0] = M31((values[0].value + 1) % ((1 << 31) - 1))
    return proof


def _stale(proof, state, _args):
    """A prover that returns its state unchanged: every job gets the first
    proof it made."""
    return state.setdefault("first", proof)


def _other_job(_proof, state, args):
    """The job's input left out: the proof of another trace."""
    config, log_n, trace_seed, device = args
    return state["real"](config, log_n, trace_seed + 1, device)


def _raises(_proof, _state, _args):
    raise RuntimeError("a proof that never comes")


@pytest.mark.parametrize("fault", [_altered, _stale, _other_job, _raises],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    real_recipe = registry.recipe

    def broken(root, cfg):
        module = real_recipe(root, cfg)
        state = {"real": module.prove}

        def prove(*args):
            return fault(module.prove(*args), state, args)

        return SimpleNamespace(prove=prove, proof_fields=module.proof_fields)

    monkeypatch.setattr(registry, "recipe", broken)
    if fault is _raises:
        with pytest.raises(RuntimeError):  # set-up's warm proof raises
            _run(tiny_checkout(tmp_path))
        return
    result = _run(tiny_checkout(tmp_path))
    assert result["correct"] is False


@pytest.mark.parametrize("sides", ["program", "program_and_reference"])
def test_a_proof_with_none_of_its_parts_is_not_correct(tmp_path,
                                                      monkeypatch, sides):
    """A recipe whose proof holds none of the configuration's parts, beside
    the reference's whole proof or beside a reference that holds none
    either: a part that one proof or neither holds counts as differing."""
    real_recipe, real_reference = registry.recipe, registry.reference

    def no_fields(root, cfg):
        module = real_recipe(root, cfg)
        return SimpleNamespace(prove=module.prove, proof_fields=lambda _: {})

    def empty_reference(root, cfg):
        module = real_reference(root, cfg)
        return SimpleNamespace(trace_inputs=module.trace_inputs,
                               prove=lambda *args: {})

    monkeypatch.setattr(registry, "recipe", no_fields)
    if sides == "program_and_reference":
        monkeypatch.setattr(registry, "reference", empty_reference)
    result = _run(tiny_checkout(tmp_path))
    assert result["correct"] is False
    assert all(result["checks"][part]["value"] >= 1 for part in PARTS)


def test_a_proof_that_fails_in_the_window_is_not_correct(tmp_path,
                                                         monkeypatch):
    real_recipe = registry.recipe

    def failing_after_warm_up(root, cfg):
        module = real_recipe(root, cfg)
        calls = {"n": 0}

        def prove(*args):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("a proof that never comes")
            return module.prove(*args)

        return SimpleNamespace(prove=prove, proof_fields=module.proof_fields)

    monkeypatch.setattr(registry, "recipe", failing_after_warm_up)
    result = _run(tiny_checkout(tmp_path))
    assert result["failed"] == 1 and result["correct"] is False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_the_tiny_cell_on_the_card_is_correct(tmp_path, cuda_device):
    result = _run(tiny_checkout(tmp_path, log_n=10, n_columns=12),
                  device=cuda_device)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
