"""Synthetic Alpaca-like prompts (a copy of the JAX package's
``training/data.py`` prompt generator): lognormal prompt lengths (median
~45 tokens, sigma 0.75) and Zipfian token ids, deterministic per seed."""
from __future__ import annotations

from typing import List

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
