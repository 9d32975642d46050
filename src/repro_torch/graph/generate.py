"""Deterministic graph generators (scaled-down stand-ins for Table 1 datasets).

The paper evaluates on web graphs (WebUK, ClueWeb), social networks (Twitter,
Friendster) and an RDF graph (BTC). We generate structurally similar graphs:
RMAT (power-law, web/social-like), Erdős–Rényi (uniform), chains/stars
(worst-case diameter / hub skew). All generators are seeded and pure numpy.

A copy of ``repro/graph/generate.py`` that gives the same graphs for the same
seeds, with a faster host path for the sizes the port runs at: the RMAT draws
are split over worker threads (each chunk starts its generator where the
single stream would be), and the dedupes sort keys without tracking indices.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.graph.csr import Graph, sorted_unique


def _rmat_bits(scale: int, m: int, a: float, b: float, c: float, seed):
    """Source and destination ids of m RMAT edges. Bit ``level`` of edge e
    comes from draw ``level * m + e`` of the seed's PCG64 stream, as one
    generator drawing ``random(m)`` level after level gives it; chunks of
    edges run on worker threads (numpy releases the GIL in this work)."""
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)

    def fill(lo: int, hi: int) -> None:
        for level in range(scale):
            bits = np.random.PCG64(seed)
            bits.advance(level * m + lo)
            r = np.random.Generator(bits).random(hi - lo)
            # quadrant probabilities a, b, c, d
            go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
            go_down = r >= a + b
            src[lo:hi] |= go_down.astype(np.int64) << level
            dst[lo:hi] |= go_right.astype(np.int64) << level

    workers = max(1, min(os.cpu_count() or 1, 8, m >> 20))
    bounds = np.linspace(0, m, workers + 1).astype(np.int64).tolist()
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, bounds[:-1], bounds[1:]))
    return src, dst


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    directed: bool = True,
    weights: str = "unit",
    sparse_ids: bool = False,
) -> Graph:
    """RMAT power-law graph with 2**scale vertices and edge_factor * n edges.

    ``sparse_ids=True`` remaps vertices to sparse 64-bit ids (to exercise the
    ID-recoding preprocessing, mirroring the paper's non-dense inputs).
    """
    n = 1 << scale
    m = edge_factor * n
    src, dst = _rmat_bits(scale, m, a, b, c, seed)
    rng = np.random.Generator(np.random.PCG64(seed))
    rng.bit_generator.advance(scale * m)  # past the draws _rmat_bits used
    # drop self loops, dedupe (sorted unique keys = edges sorted by src, dst)
    keep = src != dst
    key = sorted_unique(src[keep] * n + dst[keep])
    del src, dst, keep
    src, dst = key // n, key % n
    if weights == "unit":
        w = np.ones(src.shape[0], dtype=np.float32)
    else:
        w = rng.uniform(0.5, 2.0, size=src.shape[0]).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    if sparse_ids:
        # strictly increasing sparse relabel keeps determinism
        gaps = rng.integers(1, 1000, size=n, dtype=np.int64)
        relabel = np.cumsum(gaps)
        src, dst, ids = relabel[src], relabel[dst], relabel
    return Graph(src=src, dst=dst, weight=w, directed=directed, vertex_ids=ids)


def erdos_renyi_graph(
    n: int, avg_degree: float = 8.0, seed: int = 0, directed: bool = True
) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    keep = src != dst
    key = sorted_unique(src[keep] * n + dst[keep])
    src, dst = key // n, key % n
    w = np.ones(src.shape[0], dtype=np.float32)
    return Graph(
        src=src, dst=dst, weight=w, directed=directed,
        vertex_ids=np.arange(n, dtype=np.int64),
    )


def chain_graph(n: int, directed: bool = True) -> Graph:
    """Path graph 0→1→…→n-1: maximal diameter, the sparse-frontier worst case
    that motivates skip() (one active vertex per superstep in BFS)."""
    src = np.arange(n - 1, dtype=np.int64)
    dst = src + 1
    w = np.ones(n - 1, dtype=np.float32)
    return Graph(src=src, dst=dst, weight=w, directed=directed,
                 vertex_ids=np.arange(n, dtype=np.int64))


def star_graph(n: int, directed: bool = True) -> Graph:
    """Hub 0 → spokes 1..n-1: maximal degree skew (BTC/Twitter hub regime)."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    w = np.ones(n - 1, dtype=np.float32)
    return Graph(src=src, dst=dst, weight=w, directed=directed,
                 vertex_ids=np.arange(n, dtype=np.int64))
