"""Data pipeline (a copy of the JAX package's ``training/data.py``):
synthetic corpora with Alpaca-like statistics, numpy only.

* ``alpaca_like_prompts``: lognormal prompt lengths (median ~45 tokens,
  sigma 0.75), Zipfian token ids.
* ``lm_batches``: packed next-token-prediction batches from a sparse
  random bigram model (``MarkovLM``), so a small model shows a real
  falling loss curve.
* ``padded_prompt_batch``: right-padded prompts and their mask.

Deterministic per seed; the same seed gives the reference's arrays bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

ALPACA_MEDIAN, ALPACA_SIGMA = 45.0, 0.75


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int,
                alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids in [2, vocab) (0=pad, 1=bos reserved)."""
    ranks = np.arange(1, vocab - 2 + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(np.arange(2, vocab), size=n, p=probs).astype(np.int32)


def alpaca_like_prompts(seed: int, n: int, vocab: int,
                        median: float = ALPACA_MEDIAN,
                        sigma: float = ALPACA_SIGMA,
                        max_len: int = 2048) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(np.log(median), sigma, n), 1, max_len
                   ).astype(np.int64)
    return [zipf_tokens(rng, int(L), vocab) for L in lens]


@dataclasses.dataclass
class MarkovLM:
    """Sparse random bigram model: a learnable synthetic language."""
    vocab: int
    branching: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.next_tokens = rng.integers(
            2, self.vocab, size=(self.vocab, self.branching)).astype(np.int32)
        logits = rng.normal(0, 1.0, size=(self.vocab, self.branching))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.next_probs = e / e.sum(axis=1, keepdims=True)

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty((length,), np.int32)
        tok = int(rng.integers(2, self.vocab))
        for i in range(length):
            out[i] = tok
            j = rng.choice(self.branching, p=self.next_probs[tok])
            tok = int(self.next_tokens[tok, j])
        return out


def lm_batches(seed: int, vocab: int, batch: int, seq: int,
               branching: int = 8) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of packed {tokens, labels} batches."""
    lm = MarkovLM(vocab=vocab, branching=branching, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = np.stack([lm.sample(rng, seq + 1) for _ in range(batch)])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def padded_prompt_batch(prompts: List[np.ndarray], pad_to: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
    """Right-pad a list of prompts into (B, S) + mask (serving prefill)."""
    L = pad_to or max(len(p) for p in prompts)
    B = len(prompts)
    toks = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.int32)
    for i, p in enumerate(prompts):
        n = min(len(p), L)
        toks[i, :n] = p[:n]
        mask[i, :n] = 1
    return {"tokens": toks, "mask": mask}
