"""Deterministic synthetic-token data (a copy of the dense branch of
``repro.data.pipeline``: the port keeps its own host modules).

A seeded, structured token stream — Zipfian unigrams with a copy of the
token k places back every k-th position — so training losses move and
integration bugs show.  The same seeds give the same numpy batches as the
JAX package's pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram_repeat: int = 8     # every k-th token repeats an earlier one


class SyntheticLM:
    """Structured synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1)
        probs = 1.0 / np.power(ranks, cfg.zipf_a)
        self.probs = probs / probs.sum()

    def _sequence(self) -> np.ndarray:
        c = self.cfg
        toks = self.rng.choice(c.vocab_size, size=c.seq_len + 1,
                               p=self.probs).astype(np.int32)
        for i in range(c.ngram_repeat, c.seq_len + 1, c.ngram_repeat):
            toks[i] = toks[i - c.ngram_repeat]
        return toks

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        c = self.cfg
        while True:
            seqs = np.stack([self._sequence() for _ in range(c.batch)])
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def make_batch_fn(cfg: ModelConfig, batch: int, seq_len: int,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """An iterator of model-ready numpy batches (decoder-only LMs)."""
    if cfg.is_encoder_decoder or cfg.arch_type == "vlm":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder and VLM "
                                  "batches are not ported")
    return SyntheticLM(DataConfig(batch, seq_len, cfg.vocab_size,
                                  seed)).batches()
