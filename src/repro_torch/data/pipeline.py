"""Deterministic synthetic-token data (a copy of ``repro.data.pipeline``:
the port keeps its own host modules).

A seeded, structured token stream — Zipfian unigrams with a copy of the
token k places back every k-th position — so training losses move and
integration bugs show, plus the frontend stubs' inputs: random audio
frames for the encoder-decoder and random patch embeddings for the VLM.
The same seeds give the same numpy batches as the JAX package's pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.launch.specs import vlm_split
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
    """An iterator of model-ready numpy batches for any family.

    Encoder-decoder: ``min(seq_len, max_target_positions)`` decoder tokens
    and (batch, encoder_seq_len, d) fp32 ``frames`` of N(0, 0.02^2).  VLM:
    ``vlm_split(seq_len)`` vision embeddings (fp32, N(0, 0.02^2)) before
    the text tokens, the vision positions' labels masked (-1), and (3, B,
    S) ``positions`` whose three streams are equal (arange), as in the JAX
    pipeline.  The stubs draw from ``default_rng(seed + 1)`` in the JAX
    package's order."""
    rng = np.random.default_rng(seed + 1)
    if cfg.is_encoder_decoder:
        S_dec = min(seq_len, cfg.max_target_positions)
        stream = SyntheticLM(DataConfig(batch, S_dec, cfg.vocab_size, seed))

        def gen_encdec():
            for b in stream.batches():
                frames = rng.standard_normal(
                    (batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                        np.float32) * 0.02
                yield dict(b, frames=frames)
        return gen_encdec()
    if cfg.arch_type == "vlm":
        Sv, St = vlm_split(seq_len)
        stream = SyntheticLM(DataConfig(batch, St, cfg.vocab_size, seed))

        def gen_vlm():
            for b in stream.batches():
                vis = rng.standard_normal((batch, Sv, cfg.d_model)).astype(
                    np.float32) * 0.02
                lbl = np.concatenate(
                    [np.full((batch, Sv), -1, np.int32), b["labels"]], axis=1)
                pos = np.broadcast_to(
                    np.arange(Sv + St, dtype=np.int32)[None, None],
                    (3, batch, Sv + St))
                yield {"tokens": b["tokens"], "vision_embeds": vis,
                       "labels": lbl, "positions": np.ascontiguousarray(pos)}
        return gen_vlm()
    return SyntheticLM(DataConfig(batch, seq_len, cfg.vocab_size,
                                  seed)).batches()
