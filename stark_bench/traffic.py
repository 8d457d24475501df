"""The one traffic generator: a traffic mix is a data file of parameters,
`stark_bench/traffic/<name>.json`, that this module reads.

A closed loop of one prover: the next proof starts when the last has
returned.  Every proof proves a fresh trace whose seed is drawn from
(run seed, proof index); warm-up proofs draw theirs from another stream, so
no proof of the window repeats one of set-up.  Keys of a mix:

  loop             "closed" (the one kind there is)
  provers          1
  log_n_rows       rows of every proof, 2^log_n_rows
  warm_proofs      proofs of set-up, at the window's size
  check_proofs     proofs of the window the reference checks, a sample
                   drawn from the run seed
  profiled_proofs  traced run: proofs under torch.profiler, spans off
  span_proofs      traced run: proofs under the program's synchronised spans
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

KEYS = ("loop", "provers", "log_n_rows", "warm_proofs", "check_proofs",
        "profiled_proofs", "span_proofs")
_WINDOW, _WARM, _SAMPLE = 0, 1, 2


def _seed_sequence(seed: int, *words: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % (1 << 64), *words])


class ClosedLoop:
    def __init__(self, mix: dict, seed: int):
        missing = [k for k in KEYS if k not in mix]
        if missing:
            raise ValueError(f"traffic mix lacks {missing}")
        if mix["loop"] != "closed" or mix["provers"] != 1:
            raise ValueError("only a closed loop of one prover is defined")
        self.mix = mix
        self.seed = seed
        self.log_n_rows = int(mix["log_n_rows"])
        self._sample_rng = np.random.default_rng(
            _seed_sequence(seed, _SAMPLE))
        self._kept: List[Tuple[int, Any]] = []
        self._offered = 0

    def _trace_seed(self, stream: int, index: int) -> int:
        words = _seed_sequence(self.seed, stream, index).generate_state(
            2, np.uint64)
        return int(words[0]) << 64 | int(words[1])

    def trace_seed(self, index: int) -> int:
        """The seed of the trace of proof `index` of the window."""
        return self._trace_seed(_WINDOW, index)

    def warm_seed(self, index: int) -> int:
        return self._trace_seed(_WARM, index)

    def offer(self, index: int, item: Any) -> None:
        """Keep a uniform sample of check_proofs items of those offered
        (reservoir sampling from the run seed)."""
        k = int(self.mix["check_proofs"])
        self._offered += 1
        if len(self._kept) < k:
            self._kept.append((index, item))
            return
        j = int(self._sample_rng.integers(0, self._offered))
        if j < k:
            self._kept[j] = (index, item)

    def sample(self) -> List[Tuple[int, Any]]:
        return sorted(self._kept, key=lambda kv: kv[0])
