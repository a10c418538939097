"""The one traffic generator: every mix is a JSON file of parameters in this
directory, read here by its ``kind``.

- ``lm_batch``: an offline batch of completions.  Prompt lengths are
  lognormal and output lengths uniform, both taken as the quantiles of a
  stratum of ``stratum`` requests.  The first ``initial`` requests (set-up
  admits them all) are the stratum permuted by the seed.  Every later
  stratum serves its quantiles in one fixed order, ranks bit-reversed so
  that any run of requests spreads over the whole range, and the seed
  permutes only within each ``block`` of consecutive requests: every seed
  serves the same sizes, in another order, and a window that admits any
  number of requests admits the same sizes for every seed but a part of
  one block.  Token ids are uniform over the vocabulary.
- ``lm_pretrain``: the program's ``lm_batches`` (a seeded bigram chain over
  a Zipf marginal), frozen here; every row differs.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np

from portbench.harness.weights import derive_seed


# ---------------------------------------------------------------------------
# lm_batch
# ---------------------------------------------------------------------------


def _lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                         hi: int) -> List[int]:
    nd = NormalDist()
    return [int(min(max(round(median * math.exp(
        sigma * nd.inv_cdf((i + 0.5) / n))), lo), hi)) for i in range(n)]


def _uniform_quantiles(n: int, lo: int, hi: int) -> List[int]:
    return [int(lo + math.floor((hi - lo + 1) * (i + 0.5) / n))
            for i in range(n)]


def _spread_order(n: int) -> List[int]:
    """Ranks 0..n-1 ordered by their bit-reversed value: every aligned run
    of 2**k of them takes one rank from each of 2**k equal strata."""
    bits = max(1, (n - 1).bit_length())
    return sorted(range(n),
                  key=lambda r: int(format(r, f"0{bits}b")[::-1], 2))


def lm_requests(mix: dict, seed: int, vocab: int
                ) -> Iterator[Tuple[np.ndarray, int]]:
    """(prompt token ids int32, max new tokens), forever.  The first
    ``initial`` requests take their outputs from ``initial_output`` (so the
    first retirements spread over the window), the rest from
    ``output``."""
    rng = np.random.default_rng(derive_seed(seed, "requests"))
    n, b = mix["stratum"], mix["block"]
    p = mix["prompt"]
    prompts = _lognormal_quantiles(n, p["median"], p["sigma"], p["min"],
                                   p["max"])
    order = _spread_order(n)
    done = 0
    while True:
        first = done < mix["initial"]
        o = mix["initial_output"] if first else mix["output"]
        outs = _uniform_quantiles(n, o["min"], o["max"])
        if first:
            sizes = zip(rng.permutation(prompts), rng.permutation(outs))
        else:
            ranks = [(order[i + j], order[i + k]) for i in range(0, n, b)
                     for j, k in zip(rng.permutation(b), rng.permutation(b))]
            sizes = ((prompts[pr], outs[orr]) for pr, orr in ranks)
        for s, m in sizes:
            yield rng.integers(0, vocab, size=int(s)).astype(np.int32), int(m)
            done += 1
            if first and done == mix["initial"]:
                break


# ---------------------------------------------------------------------------
# lm_pretrain
# ---------------------------------------------------------------------------


def lm_batches(batch: int, seq: int, vocab: int, seed: int, steps: int
               ) -> List[dict]:
    """``steps`` batches of the seeded bigram chain: ``tokens``/``labels``
    int32 (batch, seq), ``mask`` float32 ones."""
    rng = np.random.default_rng(derive_seed(seed, "batches"))
    marg = 1.0 / np.arange(1, vocab + 1) ** 1.1
    marg /= marg.sum()
    shift = rng.integers(1, vocab)
    out = []
    for _ in range(steps):
        first = rng.choice(vocab, size=(batch, 1), p=marg)
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, :1] = first
        noise = rng.random((batch, seq))
        nxt = rng.choice(vocab, size=(batch, seq), p=marg)
        for t in range(seq):
            det = (toks[:, t] * 31 + shift) % vocab
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, det, nxt[:, t])
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32),
                    "mask": np.ones((batch, seq), np.float32)})
    return out
