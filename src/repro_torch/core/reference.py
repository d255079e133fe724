"""Reference oracles in numpy/scipy (the JAX package's use NetworkX, which
the port does not depend on).  Dense float32 outputs, ``1e9`` for
unreached vertices, equal to ``repro.core.reference`` on the same input.
"""
from __future__ import annotations

import heapq

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, shortest_path

INF = np.float32(1e9)


def _adjacency(n: int, src, dst) -> csr_matrix:
    return csr_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(n, n))


def bfs_levels(n: int, edges: np.ndarray, source: int = 0,
               symmetric: bool = False) -> np.ndarray:
    """Hop distance from ``source`` over the directed edges (both
    directions when ``symmetric``)."""
    e = np.asarray(edges)[:, :2].astype(np.int64)
    src, dst = e[:, 0], e[:, 1]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    d = shortest_path(_adjacency(n, src, dst), unweighted=True,
                      indices=source)
    return np.where(np.isinf(d), INF, d).astype(np.float32)


def sssp_dists(n: int, edges: np.ndarray, weights: np.ndarray,
               source: int = 0) -> np.ndarray:
    """Dijkstra from ``source``; parallel edges keep their least weight
    and path lengths are summed in float64, as NetworkX does."""
    adj = [dict() for _ in range(n)]
    for (s, d), w in zip(np.asarray(edges)[:, :2].tolist(),
                         np.asarray(weights, np.float64).tolist()):
        adj[s][d] = min(w, adj[s].get(d, w))
    dist = {source: 0.0}
    heap = [(0.0, source)]
    done = set()
    while heap:
        du, u = heapq.heappop(heap)
        if u in done:
            continue
        done.add(u)
        for v, w in adj[u].items():
            if du + w < dist.get(v, np.inf):
                dist[v] = du + w
                heapq.heappush(heap, (du + w, v))
    out = np.full(n, INF, np.float32)
    for v, d in dist.items():
        out[v] = d
    return out


def cc_labels(n: int, edges: np.ndarray) -> np.ndarray:
    """Min-vertex-id label per weakly connected component."""
    e = np.asarray(edges)[:, :2].astype(np.int64)
    _, comp = connected_components(_adjacency(n, e[:, 0], e[:, 1]),
                                   directed=True, connection="weak")
    low = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(low, comp, np.arange(n))
    return low[comp].astype(np.float32)
