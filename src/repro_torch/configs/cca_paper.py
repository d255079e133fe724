"""The paper's own workload as an architecture: the AM-CCA streaming
dynamic-graph engine (the port's copy of ``repro/configs/cca_paper.py``).
Shapes scale the chip from the paper's 32x32 to pod-scale cellular grids;
the port runs the 32x32 chip on one card (the pod shapes wait for the
sharded engine).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchBundle, shape
from repro_torch.core.config import EngineConfig

CCA_32 = EngineConfig(height=32, width=32, n_vertices=50_000, edge_cap=8,
                      ghost_slots=256, queue_cap=32, chan_cap=8, futq_cap=8,
                      io_stream_cap=8192, chunk=128)


def cca_shapes():
    return (
        # the paper's chip: 32x32 CCs, GraphChallenge 50K-vertex stream
        shape("chip_32x32_50k", "cca_stream", height=32, width=32,
              n_vertices=50_000, stream_edges=102_000),
        # pod-scale grids (one 32x32 tile of cells per device on 16x16 mesh)
        shape("chip_512x512_1m", "cca_stream", height=512, width=512,
              n_vertices=1_000_000, stream_edges=1_000_000),
        shape("chip_1024x512_2m", "cca_stream", height=1024, width=512,
              n_vertices=2_000_000, stream_edges=2_000_000),
    )


def engine_config_for(spec) -> EngineConfig:
    d = dict(spec.dims)
    return dataclasses.replace(
        CCA_32, height=d["height"], width=d["width"],
        n_vertices=d["n_vertices"],
        ghost_slots=max(16, 4 * d["n_vertices"] // (d["height"] * d["width"])),
        io_stream_cap=max(1024, 2 * d["stream_edges"] // d["width"]))


def _smoke():
    return dataclasses.replace(CCA_32, height=4, width=4, n_vertices=32,
                               ghost_slots=16, io_stream_cap=128, chunk=32)


def bundles():
    return [ArchBundle("cca-streaming-bfs", "cca", CCA_32, cca_shapes(),
                       _smoke,
                       notes="the paper's contribution itself; on one card "
                             "the grid runs as row bands over a thread-block "
                             "cluster (kernels/cca_cycle)")]
