"""A frozen copy of the port's synthetic token stream
(``repro_torch.data.pipeline``, language-model path only): Zipfian
unigrams with the token k places back repeated every k-th position.
The benchmark's reference reads its batches from here, so a change to
the program's pipeline shows as a wrong answer, not as a moved yardstick.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

ZIPF_A = 1.3
NGRAM_REPEAT = 8


class SyntheticLM:
    def __init__(self, batch: int, seq_len: int, vocab: int, seed: int):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1)
        probs = 1.0 / np.power(ranks, ZIPF_A)
        self.probs = probs / probs.sum()

    def _sequence(self) -> np.ndarray:
        toks = self.rng.choice(self.vocab, size=self.seq_len + 1,
                               p=self.probs).astype(np.int32)
        for i in range(NGRAM_REPEAT, self.seq_len + 1, NGRAM_REPEAT):
            toks[i] = toks[i - NGRAM_REPEAT]
        return toks

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            seqs = np.stack([self._sequence() for _ in range(self.batch)])
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def batches(batch: int, seq_len: int, vocab: int, seed: int
            ) -> Iterator[Dict[str, np.ndarray]]:
    return SyntheticLM(batch, seq_len, vocab, seed).batches()
