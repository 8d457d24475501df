"""The port's backend façade against the JAX package's (tolerance 0):
`TorchBackend` has the attribute table of `XlaBackend`, each entry is the
port's function of that name, and its `grind` finds the JAX nonce."""
import pytest

from tstwo_tpu import proof_of_work as jax_pow
from tstwo_tpu.backend import XlaBackend
from tstwo_tpu.channel.blake2s import Blake2sChannel as JaxChannel
from tstwo_tpu_torch import backend
from tstwo_tpu_torch import proof_of_work
from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
from tstwo_tpu_torch.ops import fft, fri_ops, prefix_sum, qm31
from tstwo_tpu_torch.pcs import quotients
from tstwo_tpu_torch.poly import circle_poly, twiddles
from tstwo_tpu_torch.vcs import blake2s_merkle

PORT_FUNCTIONS = {
    "bit_reverse_column": fft.bit_reverse,
    "evaluate": circle_poly.evaluate_values,
    "interpolate": circle_poly.interpolate_values,
    "precompute_twiddles": twiddles.precompute_twiddles,
    "fold_line": fri_ops.fold_line,
    "fold_circle_into_line": fri_ops.fold_circle_into_line,
    "decompose": fri_ops.decompose,
    "accumulate_quotients": quotients.accumulate_quotients,
    "accumulate": qm31.add,
    "grind": proof_of_work.grind,
    "commit_on_layer": blake2s_merkle.commit_on_layer,
    "inclusive_prefix_sum": prefix_sum.inclusive_prefix_sum,
    "exclusive_prefix_sum": prefix_sum.exclusive_prefix_sum,
}


def _table(cls):
    return sorted(k for k in vars(cls) if not k.startswith("_"))


def test_attribute_table_equals_the_jax_backend():
    assert _table(backend.TorchBackend) == _table(XlaBackend) == \
        sorted(PORT_FUNCTIONS)


@pytest.mark.parametrize("name", sorted(PORT_FUNCTIONS))
def test_each_entry_is_the_port_function(name):
    fn = getattr(backend.TorchBackend, name)
    assert fn is PORT_FUNCTIONS[name]
    assert fn.__module__.startswith("tstwo_tpu_torch.")


@pytest.mark.parametrize("pow_bits", [3, 12, 13])
def test_grind_equals_jax(pow_bits):
    ours, theirs = Blake2sChannel(), JaxChannel()
    ours.mix_u64(pow_bits)
    theirs.mix_u64(pow_bits)
    assert backend.TorchBackend.grind(ours, pow_bits, device="cpu") == \
        XlaBackend.grind(theirs, pow_bits) == jax_pow.grind_host(theirs,
                                                                 pow_bits)
