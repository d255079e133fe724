"""Streaming dynamic graph generators — GraphChallenge-style (paper §4).

The paper uses MIT GraphChallenge stochastic-block-partition streaming
graphs (Table 1): 50K/500K vertices, ~1.0M/10.2M edges, delivered in ten
increments under two sampling regimes:

  * **Edge sampling**   — edges arrive in random (real-world observation)
    order, so increments have near-equal size.
  * **Snowball sampling** — edges arrive as discovered by an expanding
    frontier from a start vertex, so increments grow monotonically
    (the paper's Table 1 shows 37K -> 191K for the 50K graph).

The datasets are offline here, so we synthesize stochastic-block-model
graphs of the same shape and stream them with the same two samplers.

The port's own copy of ``repro.graph.streams``: the same numpy random
call sequence, so a spec gives the same edges in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    n_vertices: int = 50_000
    n_edges: int = 1_000_000
    n_blocks: int = 32          # SBM community count
    p_in_over_p_out: float = 16.0
    increments: int = 10
    sampling: str = "edge"      # "edge" | "snowball"
    seed: int = 0
    symmetric: bool = False     # insert both directions
    kind: str = "sbm"           # "sbm" | "rmat" (power-law skew)
    # R-MAT quadrant probabilities (a,b,c; d = 1-a-b-c).  The defaults are
    # the Graph500 parameters, giving a power-law degree distribution with
    # heavy hubs — the skewed-stream regime rhizomes target (DESIGN §4.5).
    rmat_a: float = 0.57
    rmat_b: float = 0.19
    rmat_c: float = 0.19


def sbm_edges(spec: StreamSpec) -> np.ndarray:
    """Sample ~n_edges unique directed edges of a stochastic block model."""
    rng = np.random.default_rng(spec.seed)
    V, B = spec.n_vertices, spec.n_blocks
    block = rng.integers(0, B, size=V)
    m = 0
    chunks = []
    seen = set()
    # rejection-sample: propose intra-block with prob prop. to p_in ratio
    p_intra = spec.p_in_over_p_out / (spec.p_in_over_p_out + B - 1)
    while m < spec.n_edges:
        k = min(4 * (spec.n_edges - m) + 1024, 4_000_000)
        src = rng.integers(0, V, size=k)
        intra = rng.random(k) < p_intra
        # intra: dst from same block; inter: uniform
        dst = rng.integers(0, V, size=k)
        # resample intra dsts from src's block by jittering within block lists
        order = np.argsort(block, kind="stable")
        starts = np.searchsorted(block[order], np.arange(B))
        ends = np.searchsorted(block[order], np.arange(B), side="right")
        b = block[src]
        lo, hi = starts[b], ends[b]
        pick = lo + (rng.integers(0, 1 << 30, size=k) % np.maximum(hi - lo, 1))
        dst = np.where(intra, order[pick], dst)
        ok = src != dst
        src, dst = src[ok], dst[ok]
        for s, d in zip(src, dst):
            key = (int(s) << 32) | int(d)
            if key not in seen:
                seen.add(key)
                chunks.append((s, d))
                m += 1
                if m >= spec.n_edges:
                    break
    e = np.asarray(chunks, dtype=np.int64)
    return e.astype(np.int32)


def rmat_edges(spec: StreamSpec) -> np.ndarray:
    """Sample ~n_edges directed edges of an R-MAT (Kronecker) graph.

    Vertices are drawn bit-by-bit through the recursive quadrant matrix
    [[a, b], [c, d]]; with Graph500 parameters the out-degree distribution
    is power-law, so a handful of hub vertices receive degrees tens of
    times ``edge_cap`` — the pathological case for a serial ghost chain.
    Self-loops are dropped; duplicate edges are kept (they re-arrive in
    real streams and are legal inserts).
    """
    rng = np.random.default_rng(spec.seed)
    scale = max(1, int(np.ceil(np.log2(max(spec.n_vertices, 2)))))
    a, b, c = spec.rmat_a, spec.rmat_b, spec.rmat_c
    d = 1.0 - a - b - c
    assert d >= 0, "rmat probabilities exceed 1"
    src = np.zeros(0, np.int64)
    dst = np.zeros(0, np.int64)
    while len(src) < spec.n_edges:
        k = spec.n_edges - len(src) + 1024
        s = np.zeros(k, np.int64)
        t = np.zeros(k, np.int64)
        for _ in range(scale):
            q = rng.random(k)
            down = (q >= a + b).astype(np.int64)            # rows c/d
            right = (((q >= a) & (q < a + b))
                     | (q >= a + b + c)).astype(np.int64)   # cols b/d
            s = (s << 1) | down
            t = (t << 1) | right
        ok = (s != t) & (s < spec.n_vertices) & (t < spec.n_vertices)
        src = np.concatenate([src, s[ok]])
        dst = np.concatenate([dst, t[ok]])
    src, dst = src[:spec.n_edges], dst[:spec.n_edges]
    return np.stack([src, dst], axis=1).astype(np.int32)


def hub_edges(n_vertices: int, hub: int, degree: int,
              seed: int = 0) -> np.ndarray:
    """A single hub of the given out-degree plus a random tail — the
    minimal skewed stream for pinning rhizome correctness in tests."""
    rng = np.random.default_rng(seed)
    dsts = 1 + (np.arange(degree, dtype=np.int64) % (n_vertices - 1))
    dsts = np.where(dsts == hub, 0, dsts)   # no self-loops
    e = [np.stack([np.full(degree, hub, np.int64), dsts], axis=1)]
    # sparse tail so BFS has depth beyond the hub fan-out
    t_src = rng.integers(0, n_vertices, n_vertices // 2)
    t_dst = rng.integers(0, n_vertices, n_vertices // 2)
    ok = t_src != t_dst
    e.append(np.stack([t_src[ok], t_dst[ok]], axis=1))
    return np.concatenate(e).astype(np.int32)


def edge_sampled_stream(edges: np.ndarray, increments: int,
                        seed: int = 0) -> list[np.ndarray]:
    """Random arrival order, equal-size increments (Table 1 'Edge')."""
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(len(edges))
    parts = np.array_split(perm, increments)
    return [edges[p] for p in parts]


def snowball_stream(edges: np.ndarray, increments: int, source: int = 0,
                    seed: int = 0) -> list[np.ndarray]:
    """Edges arrive as discovered by BFS from `source` (Table 1 'Snowball').

    Produces monotonically growing increments like the paper by splitting
    the discovery order at quadratically spaced cut points.
    """
    n = int(max(edges[:, 0].max(), edges[:, 1].max())) + 1
    # adjacency (undirected discovery like the GraphChallenge snowball)
    order = np.zeros(len(edges), dtype=np.int64)
    adj_idx = {}
    for i, (s, d) in enumerate(edges):
        adj_idx.setdefault(int(s), []).append(i)
        adj_idx.setdefault(int(d), []).append(i)
    seen_v = np.zeros(n, bool)
    seen_e = np.zeros(len(edges), bool)
    outq = [source]
    seen_v[source] = True
    pos = 0
    k = 0
    while outq:
        nxt = []
        for v in outq:
            for ei in adj_idx.get(v, ()):
                if not seen_e[ei]:
                    seen_e[ei] = True
                    order[k] = ei
                    k += 1
                    s, d = edges[ei]
                    for u in (int(s), int(d)):
                        if not seen_v[u]:
                            seen_v[u] = True
                            nxt.append(u)
        outq = nxt
    # disconnected leftovers arrive last
    rest = np.nonzero(~seen_e)[0]
    order[k:k + len(rest)] = rest
    k += len(rest)
    order = order[:k]
    # quadratic cut points -> growing increments (paper Table 1 pattern)
    w = np.arange(1, increments + 1, dtype=np.float64)
    cuts = np.cumsum(w / w.sum()) * k
    cuts = np.unique(np.round(cuts).astype(np.int64))[:-1]
    return [edges[p] for p in np.split(order, cuts)]


def make_stream(spec: StreamSpec) -> list[np.ndarray]:
    if spec.kind == "rmat":
        edges = rmat_edges(spec)
    elif spec.kind == "sbm":
        edges = sbm_edges(spec)
    else:
        raise ValueError(spec.kind)
    if spec.symmetric:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    if spec.sampling == "edge":
        incs = edge_sampled_stream(edges, spec.increments, spec.seed)
    elif spec.sampling == "snowball":
        incs = snowball_stream(edges, spec.increments, source=0,
                               seed=spec.seed)
    else:
        raise ValueError(spec.sampling)
    # attach unit weights (bit pattern of 1.0f)
    one = np.float32(1.0).view(np.int32)
    return [np.concatenate([e, np.full((len(e), 1), one, np.int32)], axis=1)
            for e in incs]
