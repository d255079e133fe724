"""The tenant layer on a sharded cell grid: ``MQSession`` and ``FrontDesk``
with the session's state laid over a mesh (``dist.cca.shard_state``, JAX's
``device_put`` under ``cca_state_shardings``) against the JAX package's
unsharded session on the same stream, on the CPU.

One serving stream covers every path of the tenant layer: a label-flood
(CC) tenant admitted before the first edge, five more queued at the
front desk and admitted as slots free up, the last three mid-stream into
recycled slots (the CC slot's new app rebuilds the composite), and the
``tm_hiw`` gate closed by a low ``hiw_frac`` for two beats (six
deferrals).
After every beat the receipts, the deferrals and what is pending, each
slot's lifecycle, the gathered ``qchg`` / ``qlast``, the beat's counters
and every slot's values equal JAX's bit for bit, over ``LocalTiles`` at
(2, 1) and (2, 2) and over two gloo processes at (2, 1).  The port's
runs go in the two gloo processes (each then runs one ``LocalTiles``
mesh) while this one runs JAX's.  The tiles run the plain tile step
here; the card's tile instances are held to it in ``chip_smoke.py``.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.dist import cca
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve_bench import weighted_stream
from repro_torch.mq import FrontDesk, MQSession

# telemetry on (the gate reads tm_hiw), lanes 4 and rhizomes 2
KW = dict(height=4, width=4, n_vertices=16, edge_cap=8, ghost_slots=32,
          queue_cap=64, chan_cap=32, futq_cap=8, io_stream_cap=512,
          lanes=4, rhizome_cap=2, telemetry=True, chunk=32)
APPS = ["cc", "bfs", "sssp"]
QUEUED = (("bfs", 0), ("sssp", 3), ("widest", 5), ("bfs", 7), ("sssp", 9))
HIW = 0.1                       # the gate closes after the busiest beats
BEATS = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stream() -> list:
    incs = weighted_stream(16, 28, 2, 5)
    return incs + [np.zeros((0, 3), np.int32)] * (BEATS - len(incs))


def serve(session, desk, cfg, place=None, whole=None, **kw) -> list:
    """The stream through a session and its front desk; a record a beat
    (``whole(ses)``: the whole state, for the per-slot counters)."""
    ses = session(cfg, qbatch=len(APPS), apps=APPS, **kw)
    ses.admit("cc", 0, slot=0)
    if place is not None:
        place(ses)
    fd = desk(ses, hiw_frac=HIW)
    for app, src in QUEUED:
        fd.submit(app, src)
    rows = []
    for e in stream():
        r = fd.step(e)
        st = (whole or (lambda s: s.eng.state))(ses)
        rows.append(dict(
            counters=[int(x) for x in (r.cycles, r.hops, r.execs,
                                       r.stalls, r.allocs)],
            qchg=np.asarray(st.qchg).tolist(),
            qlast=np.asarray(st.qlast).tolist(),
            slots=[(s.app.name if s.app else None, s.source, s.generation,
                    s.state, s.admit_cycle, s.settle_cycle, s.increments)
                   for s in ses.slots],
            receipts=[dict(r) for r in fd.receipts],
            deferrals=fd.deferrals, pending=len(fd.pending),
            values=[np.asarray(ses.values(q)).view(np.int32).tolist()
                    for q in range(len(APPS))]))
    return json.loads(json.dumps(rows, default=int))


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """JAX's rows, and what two processes compute meanwhile: each gloo
    rank's rows at (2, 1), then rank 0's over (2, 1) and rank 1's over
    (2, 2) of ``LocalTiles``: ``(jax, {name: rows})``."""
    from repro.core.config import EngineConfig as JConfig
    from repro.mq.frontdesk import FrontDesk as JFrontDesk
    from repro.mq.session import MQSession as JSession
    from test_torch_dist_gloo import ranks
    tmp = tmp_path_factory.mktemp("mq_gloo")
    with ranks(RANK, 2, tmp, str(tmp),
               str(pathlib.Path(__file__).parent)):
        rows = serve(JSession, JFrontDesk, JConfig(backend="jnp", **KW))
    # the stream exercises what it is meant to
    assert rows[-1]["deferrals"] > 0
    assert len(rows[-1]["receipts"]) >= 4
    assert {r["app"] for r in rows[-1]["receipts"]} >= {"cc", "bfs", "sssp"}
    assert any(s[2] > 1 for s in rows[-1]["slots"])         # recycled
    return rows, {n: json.loads((tmp / f"{n}.json").read_text())
                  for n in ("rank0", "rank1", "local2x1", "local2x2")}


def sharded(mesh):
    def place(ses):
        ses.eng.state = cca.shard_state(ses.eng.cfg, ses.eng.state, mesh)
    return place


def equal_jax(rows, jax_rows, what):
    for i, (got, want) in enumerate(zip(rows, jax_rows)):
        assert got == want, f"{what} beat {i}"
    assert len(rows) == len(jax_rows)


def test_sharded_session_equals_jax(jax_rows):
    """(2, 1) of ``LocalTiles``."""
    want, got = jax_rows
    equal_jax(got["local2x1"], want, (2, 1))


def test_sharded_session_refuses_a_full_queue():
    """A seed pushed into a full action queue raises, as unsharded."""
    ses = MQSession(EngineConfig(**KW), qbatch=2, apps=["bfs", "bfs"],
                    device="cpu")
    sharded(make_host_mesh(2, 2, device="cpu"))(ses)
    for st, g in zip(ses.eng.state.tiles, ses.eng.state.geoms):
        st.aq_n[g.or0:g.or1, g.oc0:g.oc1] = KW["queue_cap"]
    with pytest.raises(RuntimeError, match="full at an increment boundary"):
        ses.admit("bfs", 0)


RANK = """
import json, sys
import torch
sys.path.insert(0, sys.argv[5])
from test_torch_mq_sharded import KW, serve, sharded
from repro_torch.core.config import EngineConfig
from repro_torch.dist.ctx import Mesh
from repro_torch.dist.transport import ProcessGroupTiles
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.mq import FrontDesk, MQSession

rank, world, init, out = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                               timeout_s=60)
try:
    mesh = Mesh((2, 1), ("data", "model"), tr)
    rows = serve(MQSession, FrontDesk, EngineConfig(**KW),
                 place=sharded(mesh), whole=lambda s: s.eng._whole(),
                 device="cpu")
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(rows, f)
finally:
    ProcessGroupTiles.close()
# then LocalTiles, (2, 1) here on rank 0 and (2, 2) on rank 1, while
# JAX's reference still runs
shape = (2, 1) if rank == 0 else (2, 2)
rows = serve(MQSession, FrontDesk, EngineConfig(**KW),
             place=sharded(make_host_mesh(*shape, device="cpu")),
             whole=lambda s: s.eng._whole(), device="cpu")
with open(f"{out}/local{shape[0]}x{shape[1]}.json", "w") as f:
    json.dump(rows, f)
print("RANK_OK", rank)
"""


def test_sharded_session_over_gloo_and_2x2_equal_jax(jax_rows):
    """Two gloo processes at (2, 1), each holding one tile, and (2, 2) of
    ``LocalTiles``."""
    want, got = jax_rows
    for name in ("rank0", "rank1", "local2x2"):
        equal_jax(got[name], want, name)
