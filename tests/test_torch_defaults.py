"""The port's device rule, held on the CPU (tolerance 0).

Every public callable of tstwo_tpu_torch that places data on a device runs
on CUDA device 0 unless the caller asks for the CPU: its `device` parameter
defaults to None, which means the device of the tensors it is given or,
where it makes data from host values, `utils.entry_device()` -- cuda:0, or
a RuntimeError where there is none.  `device="cpu"` is honoured.  The one
exception is `utils.to_torch_u32`, the numpy bridge (ALLOWED_CPU_DEFAULT).

This module keeps the lists the rule is checked against:

  * `device_parameters()`: every public function, method and class
    `__init__` of the package with a `device` parameter, and its default;
  * CREATORS: a small call of each callable that makes data from host
    values.  Here each one, called without a device, must raise the
    `entry_device` error and, called with `device="cpu"`, must give what
    the JAX package gives on the same seeded input.  chip_smoke.py (phase
    `defaults`) imports this list and calls each one without a device on
    the card, where every result must lie on cuda:0;
  * FOLLOW_INPUTS and ENTRY_POINTS: the other callables with a defaulted
    `device`, each with the reason it is not in CREATORS.  A new `device`
    parameter fails `test_every_defaulted_device_is_classified` until it
    is put in one of the three.

Last, the README's custom-AIR recipe at log 4 on the CPU, whose proof
equals the JAX recipe's byte for byte.

The module imports nothing of JAX at its top: chip_smoke.py imports it on
a machine without JAX.  The references import it inside.
"""
from __future__ import annotations

import hashlib
import importlib
import inspect
import json
import pkgutil
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import pytest
import torch

import tstwo_tpu_torch

P = (1 << 31) - 1
LOG = 4
BUILD = Path(__file__).resolve().parent.parent / "build"

ALLOWED_CPU_DEFAULT = {
    "tstwo_tpu_torch.utils.to_torch_u32":
        "the numpy bridge: it has no JAX counterpart, computes nothing, and "
        "the port's own callers name the device",
}


def device_parameters() -> dict:
    """{qualified name: default of its `device` parameter} for every public
    function, method and class `__init__` of the package
    (`inspect.Parameter.empty` where the parameter has no default)."""
    out = {}
    for info in pkgutil.walk_packages(tstwo_tpu_torch.__path__,
                                      "tstwo_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or \
                    getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                members = [(name, obj)]
            elif inspect.isclass(obj):
                members = [(f"{name}.{attr}", getattr(val, "__func__", val))
                           for attr, val in vars(obj).items()
                           if attr == "__init__" or not attr.startswith("_")]
            else:
                continue
            for qualname, fn in members:
                if not inspect.isfunction(fn):
                    continue
                param = inspect.signature(fn).parameters.get("device")
                if param is not None:
                    out[f"{mod.__name__}.{qualname}"] = param.default
    return out


DEVICE_PARAMETERS = device_parameters()


# ---------------------------------------------------------------------------
# Small inputs, the same on every device
# ---------------------------------------------------------------------------

def _m31s(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint32)


def _ints(seed: int, n: int) -> list:
    """n QM31 values as lists of 4 ints."""
    return _m31s(seed, n, 4).tolist()


def _qm31s(seed: int, n: int):
    from tstwo_tpu_torch.fields import QM31

    return [QM31.from_ints(v) for v in _ints(seed, n)]


def _jax_qm31s(seed: int, n: int):
    from tstwo_tpu.fields import QM31

    return [QM31.from_ints(v) for v in _ints(seed, n)]


DIGEST = hashlib.blake2s(b"defaults").digest()
ROOT_WORDS = np.arange(8, dtype=np.uint32) * 0x01010101
GRIND_BITS = 6
POSEIDON_DIGEST = int.from_bytes(DIGEST, "little") >> 5  # below p


def _basic_air_columns() -> list:
    """The basic AIR's trace at log 4 as numpy columns."""
    from tstwo_tpu_torch.examples.basic_air import generate_trace
    from tstwo_tpu_torch.utils import to_numpy_u32

    return [to_numpy_u32(c) for c in generate_trace(LOG, device="cpu")]


def _twiddle_half_coset(canonic_coset):
    return canonic_coset.new(LOG + 2).circle_domain().half_coset


def _commit_trace(scheme, channel, columns, evaluation, coset) -> None:
    tb = scheme.tree_builder()
    domain = coset.new(LOG).circle_domain()
    tb.extend_evals([evaluation(domain, c) for c in columns])
    tb.commit(channel)


def _port_scheme(device_kw):
    """A basic-AIR tree committed by a scheme built with `device_kw`, from
    CPU columns (to_torch_u32)."""
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
    from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
    from tstwo_tpu_torch.utils import to_torch_u32

    twiddles = precompute_twiddles(_twiddle_half_coset(CanonicCoset))
    scheme = CommitmentSchemeProver(PcsConfig(), twiddles, **device_kw)
    channel = Blake2sChannel()
    _commit_trace(scheme, channel,
                  [to_torch_u32(c) for c in _basic_air_columns()],
                  CircleEvaluation, CanonicCoset)
    return scheme, channel, twiddles


def _jax_scheme():
    import jax.numpy as jnp

    from tstwo_tpu.channel.blake2s import Blake2sChannel
    from tstwo_tpu.circle import CanonicCoset
    from tstwo_tpu.pcs import PcsConfig
    from tstwo_tpu.pcs.prover import CommitmentSchemeProver
    from tstwo_tpu.poly.circle_poly import CircleEvaluation
    from tstwo_tpu.poly.twiddles import precompute_twiddles

    twiddles = precompute_twiddles(_twiddle_half_coset(CanonicCoset))
    scheme = CommitmentSchemeProver(PcsConfig(), twiddles)
    channel = Blake2sChannel()
    _commit_trace(scheme, channel,
                  [jnp.asarray(c) for c in _basic_air_columns()],
                  CircleEvaluation, CanonicCoset)
    return scheme, channel, twiddles


def _tree_arrays(scheme) -> list:
    """The root's words, the coefficients and the evaluations of the one
    committed tree."""
    tree = scheme.trees[0]
    root = np.frombuffer(tree.commitment.root(), "<u4").reshape(8, 1)
    return ([root] + [p.coeffs for p in tree.polynomials]
            + [ev.values for ev in tree.evaluations])


def _port_tree(scheme) -> list:
    tree = scheme.trees[0]
    return ([tree.commitment.layers[0]] + [p.coeffs for p in tree.polynomials]
            + [ev.values for ev in tree.evaluations])


# ---------------------------------------------------------------------------
# The callables that make data from host values
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Creator:
    """One callable that makes data from host values.  `make(**device_kw)`
    calls it on small inputs and returns what it placed (tensors; a host
    int where the callable returns one); `reference()` gives the same
    values from the JAX package (from numpy or hashlib where the JAX
    package has no such function).  `kernel`: a kernel the call must
    launch on the card."""

    name: str
    case: str
    make: Callable
    reference: Callable
    kernel: Optional[str] = None

    @property
    def id(self) -> str:
        return f"{self.name}[{self.case}]"


def _scheme_make(**kw):
    return _port_tree(_port_scheme(kw)[0])


def _scheme_reference():
    return _tree_arrays(_jax_scheme()[0])


def _checkpoint_make(**kw):
    from tstwo_tpu_torch.serialize import (load_prover_checkpoint,
                                           save_prover_checkpoint)

    scheme, channel, twiddles = _port_scheme({"device": "cpu"})
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = str(Path(tmp) / "checkpoint.npz")
        save_prover_checkpoint(path, scheme, channel)
        loaded, _ = load_prover_checkpoint(path, twiddles, **kw)
    return _port_tree(loaded)


def _checkpoint_reference():
    from tstwo_tpu.serialize import (load_prover_checkpoint,
                                     save_prover_checkpoint)

    scheme, channel, twiddles = _jax_scheme()
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = str(Path(tmp) / "checkpoint.npz")
        save_prover_checkpoint(path, scheme, channel)
        loaded, _ = load_prover_checkpoint(path, twiddles)
    return _tree_arrays(loaded)


def _logup_fill(gen, qm31, m31) -> list:
    first = gen.new_col()
    first.write_frac(qm31.from_u32_unchecked(1, 2, 3, 4),
                     qm31.from_u32_unchecked(1, 2, 9, 8))
    first.finalize_col()
    second = gen.new_col()
    second.write_frac(m31(5), qm31.from_u32_unchecked(7, 0, 3, 1))
    second.finalize_col()
    cols, claimed = gen.finalize_last()
    return [c.values for c in cols] + [np.array(claimed.to_ints(), np.uint32)]


def _logup_make(**kw):
    from tstwo_tpu_torch.constraint_framework.logup import LogupTraceGenerator
    from tstwo_tpu_torch.fields import M31, QM31

    return _logup_fill(LogupTraceGenerator(LOG, **kw), QM31, M31)


def _logup_reference():
    from tstwo_tpu.constraint_framework.logup import LogupTraceGenerator
    from tstwo_tpu.fields import M31, QM31

    return _logup_fill(LogupTraceGenerator(LOG), QM31, M31)


def _preprocessed(cls_name):
    def make(**kw):
        from tstwo_tpu_torch.constraint_framework import preprocessed

        return [getattr(preprocessed, cls_name)(LOG).gen_column(**kw).values]

    def reference():
        from tstwo_tpu.constraint_framework import preprocessed

        return [getattr(preprocessed, cls_name)(LOG).gen_column().values]
    return make, reference


def _eq_evals_make(**kw):
    from tstwo_tpu_torch.lookups.gkr import EqEvals

    return [EqEvals.generate(_qm31s(1, 3), **kw).evals.evals]


def _eq_evals_reference():
    from tstwo_tpu.lookups.gkr import EqEvals

    return [EqEvals.generate(_jax_qm31s(1, 3)).evals.evals]


def _gen_eq_evals_make(**kw):
    from tstwo_tpu_torch.lookups.gkr import gen_eq_evals

    return [gen_eq_evals(_qm31s(2, 3), _qm31s(3, 1)[0], **kw).evals]


def _gen_eq_evals_reference():
    from tstwo_tpu.lookups.gkr import gen_eq_evals

    return [gen_eq_evals(_jax_qm31s(2, 3), _jax_qm31s(3, 1)[0]).evals]


def _mle(cls_name, source):
    """An MLE of `cls_name` from numpy or from a list of field elements."""
    def inputs(fields):
        if cls_name == "BaseMle":
            vals = _m31s(4, 16)
            return vals if source == "numpy" else \
                [fields.M31(int(v)) for v in vals]
        vals = _m31s(5, 4, 16)
        return vals if source == "numpy" else \
            [fields.QM31.from_ints(v) for v in vals.T.tolist()]

    def make(**kw):
        from tstwo_tpu_torch import fields
        from tstwo_tpu_torch.lookups import mle

        return [getattr(mle, cls_name)(inputs(fields), **kw).evals]

    def reference():
        import jax.numpy as jnp

        from tstwo_tpu import fields
        from tstwo_tpu.lookups import mle

        vals = inputs(fields)
        if source == "numpy":
            vals = jnp.asarray(vals)
        return [getattr(mle, cls_name)(vals).evals]
    return make, reference


def _digest_make(**kw):
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel

    return [Blake2sChannel(DIGEST).digest_words_device(**kw)]


def _digest_reference():
    from tstwo_tpu.channel.blake2s import Blake2sChannel

    return [Blake2sChannel(DIGEST).digest_words_device()]


def _lazy_digest_make(**kw):
    """A digest left on the device by a root mix is returned as it is."""
    from tstwo_tpu_torch.channel import device as dev
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel

    ch = Blake2sChannel(DIGEST)
    ch.mix_root_device(dev.upload_words(ROOT_WORDS, **kw))
    words = ch.digest_words_device()
    assert words is ch._device_digest
    return [words]


def _lazy_digest_reference():
    import jax.numpy as jnp

    from tstwo_tpu.channel.blake2s import Blake2sChannel

    ch = Blake2sChannel(DIGEST)
    ch.mix_root_device(jnp.asarray(ROOT_WORDS))
    return [ch.digest_words_device()]


def _upload_make(**kw):
    from tstwo_tpu_torch.channel.device import upload_words

    return [upload_words([1, (1 << 32) - 1, 5, 1 << 31], **kw)]


def _upload_reference():
    return [np.array([1, (1 << 32) - 1, 5, 1 << 31], np.uint32)]


def _state_make(**kw):
    from tstwo_tpu_torch.channel import device as dev
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel, ChannelTime

    return list(dev.state_from_channel(
        Blake2sChannel(DIGEST, ChannelTime(3, (5 << 32) + 7)), **kw))


def _state_reference():
    from tstwo_tpu.channel import device as dev
    from tstwo_tpu.channel.blake2s import Blake2sChannel, ChannelTime

    digest, _ = dev.state_from_channel(
        Blake2sChannel(DIGEST, ChannelTime(3, 7)))
    # the port keeps n_sent as two LE words, JAX as one int32
    return [digest, np.array([7, 5], np.uint32)]


def _qm31_ops(fn):
    def make(**kw):
        from tstwo_tpu_torch.fields import QM31
        from tstwo_tpu_torch.ops import qm31

        if fn == "zeros":
            return [qm31.zeros((8,), **kw)]
        return [qm31.scalar(QM31.from_ints(_ints(6, 1)[0]), **kw)]

    def reference():
        from tstwo_tpu.fields import QM31
        from tstwo_tpu.ops import qm31

        if fn == "zeros":
            return [qm31.zeros((8,))]
        return [qm31.scalar(QM31.from_ints(_ints(6, 1)[0]))]
    return make, reference


def _npqm31(fn):
    def make(**kw):
        from tstwo_tpu_torch.lookups import npqm31

        if fn == "from_qm31_list":
            return [npqm31.from_qm31_list(_qm31s(7, 5), **kw)]
        return [npqm31.scalar(_qm31s(8, 1)[0], 3, **kw)]

    def reference():
        from tstwo_tpu.lookups import npqm31

        if fn == "from_qm31_list":
            return [npqm31.from_qm31_list(_jax_qm31s(7, 5))]
        return [npqm31.scalar(_jax_qm31s(8, 1)[0], 3)]
    return make, reference


FELTS = [0, 1, (1 << 251) + 17 * (1 << 192), (1 << 200) + 12345]


def _felts_make(**kw):
    from tstwo_tpu_torch.ops.poseidon252 import ints_to_felts

    return [ints_to_felts(FELTS, **kw)]


def _felts_reference():
    """Eight LE words a felt, one column each; the JAX package keeps felts
    as 21 limbs of 12 bits, so the words are computed here."""
    return [np.array([[(v >> (32 * w)) & 0xFFFFFFFF for v in FELTS]
                      for w in range(8)], np.uint32)]


def _line_zero_make(**kw):
    from tstwo_tpu_torch.circle import Coset
    from tstwo_tpu_torch.poly.line import LineDomain, LineEvaluation

    return [LineEvaluation.new_zero(LineDomain.new(Coset.half_odds(3)),
                                    **kw).values]


def _line_zero_reference():
    from tstwo_tpu.circle import Coset
    from tstwo_tpu.poly.line import LineDomain, LineEvaluation

    return [LineEvaluation.new_zero(LineDomain.new(Coset.half_odds(3))).values]


def _points_make(**kw):
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.pcs.quotients import domain_points_bitrev

    return list(domain_points_bitrev(CanonicCoset.new(LOG).circle_domain(),
                                     **kw))


def _points_reference():
    from tstwo_tpu.circle import CanonicCoset
    from tstwo_tpu.pcs.quotients import domain_points_bitrev

    return list(domain_points_bitrev(CanonicCoset.new(LOG).circle_domain()))


def _itwiddles_make(**kw):
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.ops.fri_ops import domain_y_itwiddles

    return [domain_y_itwiddles(CanonicCoset.new(LOG).circle_domain(), **kw)]


def _itwiddles_reference():
    from tstwo_tpu.circle import CanonicCoset
    from tstwo_tpu.ops.fri_ops import domain_y_itwiddles

    return [domain_y_itwiddles(CanonicCoset.new(LOG).circle_domain())]


def _twiddles(fn):
    def call(circle, twiddles, **kw):
        tree = twiddles.precompute_twiddles(
            circle.CanonicCoset.new(LOG).circle_domain().half_coset)
        if fn == "layer_of_size":
            return [tree.layer_of_size(4, True, **kw)]
        return twiddles.domain_line_twiddles(LOG, tree, False, **kw)

    def make(**kw):
        from tstwo_tpu_torch import circle
        from tstwo_tpu_torch.poly import twiddles

        return call(circle, twiddles, **kw)

    def reference():
        from tstwo_tpu import circle
        from tstwo_tpu.poly import twiddles

        return call(circle, twiddles)
    return make, reference


def _accumulator(accumulator, qm31, **kw):
    acc = accumulator.DomainEvaluationAccumulator(
        qm31.from_ints([1, 2, 3, 4]), 3, 1, **kw)
    (col,) = acc.columns([(3, 1)])
    return [col.col]


def _accumulator_make(**kw):
    from tstwo_tpu_torch.air import accumulator
    from tstwo_tpu_torch.fields import QM31

    return _accumulator(accumulator, QM31, **kw)


def _accumulator_reference():
    from tstwo_tpu.air import accumulator
    from tstwo_tpu.fields import QM31

    return _accumulator(accumulator, QM31)


def _grind_reference():
    from tstwo_tpu.channel.blake2s import Blake2sChannel
    from tstwo_tpu.proof_of_work import grind_host

    return [grind_host(Blake2sChannel(DIGEST), GRIND_BITS)]


def _grind(fn):
    def make(**kw):
        from tstwo_tpu_torch.ops import blake2s as b2

        words = b2.digest_bytes_to_words(DIGEST)
        out = getattr(b2, fn)(words, 0, 1 << 12, GRIND_BITS, **kw)
        return [out] if fn == "grind_hit_plain" else [int(out)]

    def reference():
        nonce = _grind_reference()[0]
        return [np.array([nonce])] if fn == "grind_hit_plain" else [nonce]
    return make, reference


def _poseidon_grind_reference():
    from tstwo_tpu.channel.poseidon import FieldElement252, Poseidon252Channel
    from tstwo_tpu.proof_of_work import grind_host

    return [grind_host(Poseidon252Channel(FieldElement252(POSEIDON_DIGEST)),
                       GRIND_BITS)]


def _poseidon_grind(fn):
    """The Poseidon252 grind's scan of 64 nonces from a felt digest."""
    def make(**kw):
        from tstwo_tpu_torch.ops import poseidon252 as pos

        out = getattr(pos, fn)(POSEIDON_DIGEST, 0, 64, GRIND_BITS, **kw)
        return [out] if fn == "poseidon_grind_hit_plain" else [int(out)]

    def reference():
        nonce = _poseidon_grind_reference()[0]
        return ([np.array([nonce])] if fn == "poseidon_grind_hit_plain"
                else [nonce])
    return make, reference


def _pow(fn):
    """The grind from a channel at pow_bits 12, where it runs on the
    device."""
    def make(**kw):
        from tstwo_tpu_torch import proof_of_work
        from tstwo_tpu_torch.backend import TorchBackend
        from tstwo_tpu_torch.channel.blake2s import Blake2sChannel

        owner = TorchBackend if fn == "TorchBackend.grind" else proof_of_work
        return [getattr(owner, fn.split(".")[-1])(Blake2sChannel(DIGEST), 12,
                                                  **kw)]

    def reference():
        from tstwo_tpu.channel.blake2s import Blake2sChannel
        from tstwo_tpu.proof_of_work import grind_host

        return [grind_host(Blake2sChannel(DIGEST), 12)]
    return make, reference


def _empty_layer(module, fn, n=4):
    """A Merkle layer of n nodes that hash no value: no tensor is given,
    so the device is the one named or cuda:0."""
    def make(**kw):
        mod = importlib.import_module(f"tstwo_tpu_torch.{module}")
        owner = mod.TorchBackend if module == "backend" else mod
        if fn == "commit_on_layer":
            return [owner.commit_on_layer(n.bit_length() - 1, None, [], **kw)]
        return [getattr(owner, fn)(None, [], n, **kw)]

    def reference():
        if "poseidon" in module:
            from tstwo_tpu.vcs.poseidon252_merkle import hash_node

            node = hash_node(None, []).value
            words = [(node >> (32 * w)) & 0xFFFFFFFF for w in range(8)]
        else:
            words = np.frombuffer(hashlib.blake2s(b"").digest(), "<u4")
        return [np.repeat(np.array(words, np.uint32)[:, None], n, axis=1)]
    return make, reference


def _creator(name, case, make_reference, kernel=None):
    make, reference = make_reference
    return Creator(f"tstwo_tpu_torch.{name}", case, make, reference, kernel)


CREATORS = [
    _creator("pcs.prover.CommitmentSchemeProver.__init__", "basic air log 4",
             (_scheme_make, _scheme_reference), "blake2s"),
    _creator("serialize.load_prover_checkpoint", "basic air log 4",
             (_checkpoint_make, _checkpoint_reference)),
    _creator("constraint_framework.logup.LogupTraceGenerator.__init__",
             "scalar fractions", (_logup_make, _logup_reference)),
    _creator("constraint_framework.preprocessed.IsFirst.gen_column", "log 4",
             _preprocessed("IsFirst")),
    _creator("constraint_framework.preprocessed.Seq.gen_column", "log 4",
             _preprocessed("Seq")),
    _creator("lookups.gkr.EqEvals.generate", "3 variables",
             (_eq_evals_make, _eq_evals_reference)),
    _creator("lookups.gkr.gen_eq_evals", "3 variables",
             (_gen_eq_evals_make, _gen_eq_evals_reference)),
    _creator("lookups.mle.Mle.__init__", "numpy", _mle("Mle", "numpy")),
    _creator("lookups.mle.Mle.__init__", "qm31 list", _mle("Mle", "list")),
    _creator("lookups.mle.Mle.__init__", "SecureMle numpy",
             _mle("SecureMle", "numpy")),
    _creator("lookups.mle.BaseMle.__init__", "numpy",
             _mle("BaseMle", "numpy")),
    _creator("lookups.mle.BaseMle.__init__", "m31 list",
             _mle("BaseMle", "list")),
    _creator("channel.blake2s.Blake2sChannel.digest_words_device",
             "host digest", (_digest_make, _digest_reference)),
    _creator("channel.blake2s.Blake2sChannel.digest_words_device",
             "device digest", (_lazy_digest_make, _lazy_digest_reference),
             "blake2s_transcript"),
    _creator("channel.device.upload_words", "4 words",
             (_upload_make, _upload_reference)),
    _creator("channel.device.state_from_channel", "host channel",
             (_state_make, _state_reference)),
    _creator("ops.qm31.scalar", "one value", _qm31_ops("scalar")),
    _creator("ops.qm31.zeros", "8 values", _qm31_ops("zeros")),
    _creator("lookups.npqm31.from_qm31_list", "5 values",
             _npqm31("from_qm31_list")),
    _creator("lookups.npqm31.scalar", "3 copies", _npqm31("scalar")),
    _creator("ops.poseidon252.ints_to_felts", "edge felts",
             (_felts_make, _felts_reference)),
    _creator("poly.line.LineEvaluation.new_zero", "log 3",
             (_line_zero_make, _line_zero_reference)),
    _creator("pcs.quotients.domain_points_bitrev", "log 4",
             (_points_make, _points_reference)),
    _creator("ops.fri_ops.domain_y_itwiddles", "log 4",
             (_itwiddles_make, _itwiddles_reference)),
    _creator("poly.twiddles.TwiddleTree.layer_of_size", "inverse size 4",
             _twiddles("layer_of_size")),
    _creator("poly.twiddles.domain_line_twiddles", "log 4",
             _twiddles("domain_line_twiddles")),
    _creator("air.accumulator.DomainEvaluationAccumulator.__init__",
             "one column log 3", (_accumulator_make, _accumulator_reference)),
    _creator("ops.blake2s.grind_batch", "pow_bits 6", _grind("grind_batch"),
             "blake2s_grind"),
    _creator("ops.blake2s.grind_batch_plain", "pow_bits 6",
             _grind("grind_batch_plain")),
    _creator("ops.blake2s.grind_hit_plain", "pow_bits 6",
             _grind("grind_hit_plain")),
    _creator("ops.poseidon252.poseidon_grind_batch", "pow_bits 6",
             _poseidon_grind("poseidon_grind_batch"), "poseidon_grind"),
    _creator("ops.poseidon252.poseidon_grind_hit_plain", "pow_bits 6",
             _poseidon_grind("poseidon_grind_hit_plain")),
    _creator("proof_of_work.grind", "pow_bits 12", _pow("grind"),
             "blake2s_grind"),
    _creator("proof_of_work.grind_device", "pow_bits 12",
             _pow("grind_device"), "blake2s_grind"),
    _creator("backend.TorchBackend.grind", "pow_bits 12",
             _pow("TorchBackend.grind"), "blake2s_grind"),
    _creator("ops.blake2s.merkle_layer", "no value",
             _empty_layer("ops.blake2s", "merkle_layer"), "blake2s"),
    _creator("ops.blake2s.merkle_layer_plain", "no value",
             _empty_layer("ops.blake2s", "merkle_layer_plain")),
    _creator("vcs.blake2s_merkle.commit_on_layer", "no value",
             _empty_layer("vcs.blake2s_merkle", "commit_on_layer"),
             "blake2s"),
    _creator("backend.TorchBackend.commit_on_layer", "no value",
             _empty_layer("backend", "commit_on_layer"), "blake2s"),
    _creator("ops.poseidon252.merkle_layer", "no value",
             _empty_layer("ops.poseidon252", "merkle_layer", 2),
             "poseidon_merkle_layer"),
    _creator("ops.poseidon252.merkle_layer_plain", "no value",
             _empty_layer("ops.poseidon252", "merkle_layer_plain", 2)),
]

# A defaulted `device` that is not in CREATORS, and why.
FOLLOW_INPUTS = {
    f"tstwo_tpu_torch.{name}": "works where its tensors lie; without "
    "columns it needs the device named (ValueError) or, for the CUDA "
    "wrapper, a CUDA device"
    for name in ("ops.blake2s.merkle_layer_cuda",
                 "ops.poseidon252.merkle_layer_cuda",
                 "vcs.ops.Blake2sMerkleOps.commit",
                 "vcs.ops.Poseidon252MerkleOps.commit",
                 "vcs.prover.MerkleProver.commit",
                 "vcs.poseidon252_merkle.Poseidon252MerkleProver.commit")
}
ENTRY_POINTS = {
    **{f"tstwo_tpu_torch.examples.{name}": "an example's entry point: "
       "tests/test_torch_fft.py and the other prove tests call it with "
       "device=\"cpu\", chip_smoke.py without a device"
       for name in ("wide_fibonacci.generate_trace",
                    "wide_fibonacci.prove_wide_fibonacci",
                    "basic_air.generate_trace", "basic_air.prove_basic_air",
                    "logup_lookup.generate_trace",
                    "logup_lookup.prove_logup_lookup",
                    "poseidon2.generate_trace", "poseidon2.prove_poseidon2",
                    "tutorial.example_01_writing_a_spreadsheet",
                    "tutorial.example_02_from_spreadsheet_to_trace_"
                    "polynomials",
                    "tutorial.example_03_committing_to_the_trace_polynomials",
                    "tutorial.example_04_constraints_over_trace_polynomial",
                    "tutorial.example_05_proving_an_air")},
    "tstwo_tpu_torch.measure_poseidon.measure": "a measurement script for "
    "the card",
    **{f"tstwo_tpu_torch.parallel.mesh.{name}": "needs an initialised "
       "process group (tests/test_torch_parallel.py)"
       for name in ("make_mesh", "make_mesh2d")},
    "tstwo_tpu_torch.utils.entry_device": "the rule itself",
    "tstwo_tpu_torch.utils.mesh_device": "the rule under a mesh",
}


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qualname", sorted(DEVICE_PARAMETERS))
def test_device_parameter_defaults_to_none(qualname):
    default = DEVICE_PARAMETERS[qualname]
    if qualname in ALLOWED_CPU_DEFAULT:
        assert default == "cpu"
    else:
        assert default is None or default is inspect.Parameter.empty, \
            f"{qualname}: device defaults to {default!r}"


def test_every_defaulted_device_is_classified():
    defaulted = {name for name, default in DEVICE_PARAMETERS.items()
                 if default is None}
    creators = {c.name for c in CREATORS}
    assert not creators & set(FOLLOW_INPUTS)
    assert not creators & set(ENTRY_POINTS)
    assert defaulted == creators | set(FOLLOW_INPUTS) | set(ENTRY_POINTS)
    assert set(ALLOWED_CPU_DEFAULT) <= set(DEVICE_PARAMETERS)


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.cpu()
        if value.dtype == torch.int32:
            return value.numpy().view(np.uint32)
        return value.numpy()
    return np.asarray(value)


@pytest.mark.parametrize("creator", CREATORS, ids=lambda c: c.id)
def test_creator_goes_to_the_card_unless_asked(creator, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device=\"cpu\""):
        creator.make()
    got = creator.make(device="cpu")
    assert all(t.device.type == "cpu" for t in got
               if isinstance(t, torch.Tensor))
    want = creator.reference()
    assert len(got) == len(want)
    for ours, theirs in zip(got, want):
        np.testing.assert_array_equal(_host(ours), np.asarray(theirs))


def test_tensor_inputs_keep_their_device(monkeypatch):
    """Without CUDA, what follows its tensors needs no device."""
    from tstwo_tpu_torch.lookups.mle import Mle
    from tstwo_tpu_torch.utils import to_torch_u32
    from tstwo_tpu_torch.vcs.ops import Blake2sMerkleOps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    evals = to_torch_u32(_m31s(9, 4, 8))
    assert Mle(evals).evals is evals
    tree = Blake2sMerkleOps.commit([to_torch_u32(_m31s(10, 8))])
    assert tree.layers[0].device.type == "cpu"
    with pytest.raises(ValueError, match="needs its device"):
        Blake2sMerkleOps.commit([])


# ---------------------------------------------------------------------------
# The README's custom-AIR recipe, in either package
# ---------------------------------------------------------------------------

def readme_recipe(pkg: str, device_kw: dict):
    """The squares AIR (col2 = col1^2) of README.md at log 4, proved and
    verified through `pkg`'s public classes; returns the proof."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    CanonicCoset = mod("circle").CanonicCoset
    framework = mod("constraint_framework")
    PcsConfig = mod("pcs").PcsConfig
    prover = mod("prover")

    class SquaresEval(framework.FrameworkEval):
        def log_size(self):
            return LOG

        def max_constraint_log_degree_bound(self):
            return LOG + 1

        def kernel_cache_key(self):
            return (LOG,)

        def evaluate(self, ev):
            col1 = ev.next_trace_mask()
            col2 = ev.next_trace_mask()
            ev.add_constraint(col1 * col1 - col2)
            return ev

    col1 = _m31s(0, 1 << LOG)
    col2 = (col1.astype(np.uint64) ** 2 % P).astype(np.uint32)
    if pkg == "tstwo_tpu":
        import jax.numpy as jnp

        cols = [jnp.asarray(c) for c in (col1, col2)]
    else:
        cols = [mod("utils").to_torch_u32(c) for c in (col1, col2)]
    domain = CanonicCoset.new(LOG).circle_domain()
    trace = [mod("poly.circle_poly").CircleEvaluation(domain, c)
             for c in cols]
    config = PcsConfig()
    twiddles = mod("poly.twiddles").precompute_twiddles(
        CanonicCoset.new(LOG + 1 + config.fri_config.log_blowup_factor)
        .circle_domain().half_coset)
    Channel = mod("channel.blake2s").Blake2sChannel
    channel = Channel()
    scheme = mod("pcs.prover").CommitmentSchemeProver(config, twiddles,
                                                      **device_kw)
    tb = scheme.tree_builder()
    tb.extend_evals([])
    tb.commit(channel)
    channel.mix_u64(LOG)
    tb = scheme.tree_builder()
    tb.extend_evals(trace)
    tb.commit(channel)
    component = framework.FrameworkComponent(
        framework.TraceLocationAllocator(), SquaresEval(),
        mod("fields").QM31.zero())
    proof = prover.prove([component], channel, scheme)

    vch = Channel()
    vscheme = mod("pcs.verifier").CommitmentSchemeVerifier(config)
    sizes = component.trace_log_degree_bounds()
    vscheme.commit(proof.commitments[0], sizes[0], vch)
    vch.mix_u64(LOG)
    vscheme.commit(proof.commitments[1], sizes[1], vch)
    prover.verify([component], vch, vscheme, proof)
    return proof


def test_readme_recipe_proof_equals_the_jax_recipe_proof(monkeypatch):
    from tstwo_tpu.serialize import proof_to_dict as jax_proof_to_dict
    from tstwo_tpu_torch.serialize import proof_to_dict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        readme_recipe("tstwo_tpu_torch", {})
    ours = readme_recipe("tstwo_tpu_torch", {"device": "cpu"})
    theirs = readme_recipe("tstwo_tpu", {})
    assert json.dumps(proof_to_dict(ours), sort_keys=True) == \
        json.dumps(jax_proof_to_dict(theirs), sort_keys=True)
