"""The seeded inputs of the two-process sharded-index test
(tests/test_torch_parallel.py), shared by the test and its ranks: the
ranks import only numpy and the port."""

import numpy as np


def corpora():
    """The 2-rank test's seeded inputs: a dense corpus with rows tied
    across the two ranks' shards, queries, and BM25 items."""
    rng = np.random.default_rng(31)
    n, d = 8 * 512 + 300, 32
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[[5, 2100, 4300]] = emb[4000]  # a tie that spans shards and ranks
    queries = np.stack([emb[4000]] + [(emb[i] + 0.05 * rng.standard_normal(d)).astype(np.float32)
                                      for i in range(0, 4000, 700)])
    words = ["alps", "climate", "glacier", "peak", "valley", "snow", "river", "pass", "boundary", "cadibona"]
    items = [list(rng.choice(words, size=int(rng.integers(3, 12)))) for _ in range(150)]
    items[10] = items[140] = items[75] = ["dolomites", "pass"]  # tied: the later item first, across ranks
    bm25_queries = [["dolomites"], ["cadibona", "pass"], ["alps"], ["snow", "river", "snow"], ["missing"]]
    return emb, queries, items, bm25_queries
