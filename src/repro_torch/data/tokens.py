"""Synthetic token streams for the LM examples (the port of
``repro.data.tokens``, numpy only, so the tokens equal the reference's for
the same seed, vocab, batch and sequence length).

Each decentralized node gets its own token distribution (a node-specific
permutation of a Zipf-distributed unigram model composed with a shared
order-1 Markov mixing), so local losses genuinely diverge across nodes —
the regime where DR-DSGD's robust reweighting matters.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokenStream:
    """Deterministic infinite token stream for one node."""

    vocab: int
    seed: int
    zipf_a: float = 1.2
    perm_seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.perm_seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        probs /= probs.sum()
        self._probs = probs[rng.permutation(self.vocab)]
        self._rng = np.random.default_rng(self.seed)

    def next_batch(self, batch: int, seq_len: int) -> np.ndarray:
        """(batch, seq_len+1) int32 — inputs are [:, :-1], labels [:, 1:].

        Sequences mix the node unigram with a deterministic local structure
        (token t+1 ≡ f(token t) half the time) so there is signal to learn.
        """
        b = self._rng.choice(self.vocab, size=(batch, seq_len + 1), p=self._probs)
        # order-1 structure: with prob 0.5 the next token is (prev*31+7) % vocab
        mask = self._rng.random((batch, seq_len)) < 0.5
        for t in range(seq_len):
            nxt = (b[:, t] * 31 + 7) % self.vocab
            b[:, t + 1] = np.where(mask[:, t], nxt, b[:, t + 1])
        return b.astype(np.int32)


def make_node_token_streams(num_nodes: int, vocab: int, seed: int = 0,
                            hetero: bool = True) -> list[SyntheticTokenStream]:
    """One stream per node; ``hetero`` gives each node its own permutation."""
    return [
        SyntheticTokenStream(
            vocab=vocab,
            seed=seed * 1000 + k,
            perm_seed=(seed * 77 + k) if hetero else seed,
        )
        for k in range(num_nodes)
    ]
