"""Record the 32x32 fingerprint that the PyTorch port is held to.

Runs the JAX engine (``repro``) on the default stream of
``examples/streaming_bfs.py`` -- 2000 vertices, 20k SBM edges, edge
sampling, seed 1, ten increments, on a 32x32 chip -- and writes the
per-increment counters and the final BFS values to
``src/repro_torch/data/fingerprint_32x32.json``.  ``chip_smoke.py`` and
the port's tests replay it.  Outside the tests, this is the only file
of the port's tooling that imports JAX: it imports ``repro`` and never
``repro_torch``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py
"""
import dataclasses
import json
import pathlib
import subprocess

import numpy as np

from repro.core import EngineConfig, StreamingEngine
from repro.graph.streams import StreamSpec, make_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "data" / "fingerprint_32x32.json"
COMMAND = "PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py"
MAX_CYCLES = 2_000_000


def main() -> None:
    n = 2000
    spec = StreamSpec(n_vertices=n, n_edges=20_000, increments=10,
                      sampling="edge", seed=1, kind="sbm")
    # the config examples/streaming_bfs.py builds for its defaults
    cfg = EngineConfig(height=32, width=32, n_vertices=n, edge_cap=8,
                       ghost_slots=max(32, 3 * n // 1024),
                       io_stream_cap=2 ** 20, chunk=512)
    incs = make_stream(spec)
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows = []
    for i, e in enumerate(incs):
        r = eng.run_increment(e, max_cycles=MAX_CYCLES)
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
        print(f"increment {i}: {rows[-1]}", flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = dict(command=COMMAND, commit=commit, engine="repro (JAX, jnp backend)",
               spec=dataclasses.asdict(spec),
               cfg=dataclasses.asdict(cfg),
               max_cycles=MAX_CYCLES, source=0,
               increments=rows, total_cycles=eng.total_cycles,
               values=[float(v) for v in eng.values(n)])
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
