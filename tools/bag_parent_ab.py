"""The bag backward against an earlier commit's, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/bag_parent_ab.py build/parent

Loads that checkout's EmbeddingBag wrapper (its
``kernels/embedding_bag/ops.py``, as a module of another name, so its
``launch_bwd`` runs as it ran there) and builds its library from that
checkout's source beside this tree's, one nvcc each, started together.
Then at DLRM-RM2's train_batch (B = 65,536, 26 x 4 lookups, D = 64, the
tables cut to 2^20 rows: 14,723,072 rows; the batch of
``data.pipeline.recsys_batch``) and at skew4 (the same shape, each
lookup's row floor(V_f u^4) for u uniform from a seeded generator on the
card):

* both calls' gradients within 1e-5 x max(1, max |ref|) of the plain
  sum taken in float64 (``index_add_`` on float64, as ``chip_smoke.py``'s
  phase 49 holds the kernel: f32 ``index_add_`` adds by atomics, so its
  sum moves from run to run), f32 ``index_add_``'s distance
  (``ref.embedding_bags_bwd_ref``) from the same sum printed beside
  them, and the share of rows whose bits equal the earlier call's;
* both calls timed in turns (earlier, this, this, earlier);
* this tree's sort of the key pass's pairs (CUB's radix sort over the key
  bits) timed beside ``torch.sort`` of the int32 keys (all 32 bits);
* the segments and rows kernels at each segment S of ``SEGMENTS``, each
  from a library built with ``-DBAG_BWD_SEGMENT=S`` (32 is this tree's),
  equal bit for bit to ``ref.embedding_bags_bwd_ordered(..., segment=S)``
  and timed on the same sorted pairs.

Times are by CUDA events, over calls that allocate their outputs as the
wrappers do.  Prints the card, a line a case and, last, one JSON line of
the numbers.  Needs one card; about three minutes, the builds included.
"""
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import recsys_shapes  # noqa: E402
from repro_torch.configs.recsys_archs import DLRM_RM2  # noqa: E402
from repro_torch.data.pipeline import (RecSysBatchSpec,  # noqa: E402
                                       recsys_batch)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    SEGMENT, embedding_bags_bwd_ordered, embedding_bags_bwd_ref)

CUT_ROWS = 1 << 20   # each table cut to 2^20 rows, as chip_smoke.py's 49-50
REPS = 20
TOL = 1e-5
SEGMENTS = (32, 64, 128, 256)   # the S the kernels are built and timed at


def f64_sum(vocabs, idx, gout) -> list:
    """The tables' gradients (sum, no weights) by ``index_add_`` in
    float64: the yardstick both calls are held to."""
    (B, Fn, L), D = idx.shape, gout.shape[2]
    out = []
    for f, V in enumerate(vocabs):
        i = idx[:, f].long()
        i = torch.where(i < 0, i + V, i)
        keep = ((i >= 0) & (i < V)).reshape(-1)
        terms = gout[:, f].double()[:, None, :].expand(B, L, -1)
        out.append(torch.zeros((V, D), dtype=torch.float64,
                               device=gout.device).index_add_(
            0, i.reshape(-1)[keep], terms.reshape(B * L, D)[keep]))
    return out


def load_earlier(tree: pathlib.Path):
    """The earlier checkout's bag wrapper module."""
    path = tree / "src" / "repro_torch" / "kernels" / "embedding_bag"
    path = path / "ops.py"
    spec = importlib.util.spec_from_file_location("earlier_bag_ops", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cuda_ms(fn) -> float:
    fn()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def in_turns(old, new) -> dict:
    """{"earlier": [ms, ms], "this": [ms, ms]}, timed earlier, this, this,
    earlier."""
    turns = {"earlier": [], "this": []}
    for which in ("earlier", "this", "this", "earlier"):
        turns[which].append(cuda_ms(old if which == "earlier" else new))
    return turns


def segment_libraries() -> dict:
    """{S: this tree's library built with segment S}, one nvcc each,
    started together."""
    return {S: ops.load(path) for S, (path, _) in zip(
        SEGMENTS, _build.build_all(
            [lambda S=S: ops.build(() if S == SEGMENT
                                   else (f"-DBAG_BWD_SEGMENT={S}",))
             for S in SEGMENTS]))}


def kernels_at(lib, S, keys, pos, gout, grad, L) -> None:
    """``ops.bwd_kernel`` (both kernels, sum, no weights) on a library
    built with segment ``S``."""
    n, (total, D) = keys.numel(), grad.shape
    partial = torch.empty((-(-n // S), 2, D), device=grad.device)
    align = min(ops._alignment(x.data_ptr()) for x in (gout, grad, partial))
    err = lib.embedding_bag_bwd_launch(
        keys.data_ptr(), pos.data_ptr(), gout.data_ptr(), None,
        grad.data_ptr(), partial.data_ptr(), n, total, L, D, 0, S,
        *ops.bwd_shape(D, align), ops.BWD_ALL,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the backward at S = {S} failed: "
                           + lib.embedding_bag_error_string(err).decode())


def batches(vocabs, dev):
    """(name, indices [B, 26, 4] int32) of the two cases."""
    B = recsys_shapes()[0].dim("batch")
    F, L = DLRM_RM2.n_sparse, DLRM_RM2.lookups_per_field
    spec = RecSysBatchSpec(B, DLRM_RM2.n_dense, F, L, tuple(vocabs))
    yield "train_batch", torch.from_numpy(recsys_batch(spec, 0)["sparse"]).to(
        dev)
    gen = torch.Generator(device=dev).manual_seed(49)
    V = torch.tensor(vocabs, dtype=torch.float64, device=dev)[None, :, None]
    u = torch.rand((B, F, L), generator=gen, device=dev, dtype=torch.float64)
    yield "skew4", (V * u ** 4).floor().clamp_max(V - 1).to(torch.int32)


def case(earlier, libs, name, tables, idx, dev) -> dict:
    vocabs = [t.shape[0] for t in tables]
    B, F, L = idx.shape
    gout = torch.randn((B, F, tables.D),
                       generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev)
    old_tables = earlier.prepare_tables(list(tables))
    old = lambda: earlier.launch_bwd(old_tables, idx, gout)  # noqa: E731
    new = lambda: ops.launch_bwd(tables, idx, gout)  # noqa: E731
    want = f64_sum(vocabs, idx, gout)
    got_old, got_new = old(), new()
    err, same_rows = {}, 0
    for which, got in (("earlier", got_old), ("this", got_new),
                       ("index_add_ f32",
                        embedding_bags_bwd_ref(vocabs, idx, gout))):
        err[which] = max(
            float((a.double() - w).abs().max())
            / max(1.0, float(w.abs().max())) for a, w in zip(got, want))
    for a, b in zip(got_old, got_new):
        same_rows += int((a.view(torch.int32) == b.view(torch.int32))
                         .all(1).sum())
    del got_old, got_new, want
    if max(err["earlier"], err["this"]) > TOL:
        raise AssertionError(f"{name}: off the f64 sum by {err} x max(1, "
                             f"max |ref|), over {TOL}")
    turns = in_turns(old, new)
    keys, pos = ops.bwd_key_pass(tables, idx)
    sorts = dict(cub=cuda_ms(lambda: ops.bwd_sort(keys, pos, tables.total)),
                 torch=cuda_ms(lambda: torch.sort(keys, stable=True)))
    del keys, pos
    # the kernels at each S, on the same sorted pairs
    keys, pos, _ = ops.bwd_keys(tables, idx)
    grad = torch.empty((tables.total, tables.D), device=dev)
    by_segment = {}
    for S, lib in libs.items():
        kernels_at(lib, S, keys, pos, gout, grad, L)
        want = embedding_bags_bwd_ordered(vocabs, idx, gout, segment=S)
        if not torch.equal(grad.view(torch.int32),
                           torch.cat(want).view(torch.int32)):
            raise AssertionError(f"{name}: not the ordered sum's bits at "
                                 f"S = {S}")
        del want
        by_segment[S] = cuda_ms(
            lambda S=S, lib=lib: kernels_at(lib, S, keys, pos, gout, grad, L))
    del keys, pos, grad
    torch.cuda.empty_cache()
    row = dict(batch=name, B=B, F=F, L=L, D=tables.D, rows=tables.total,
               earlier_ms=turns["earlier"], this_ms=turns["this"],
               speedup=sum(turns["earlier"]) / sum(turns["this"]),
               rel_err=err, same_bits_rows=same_rows,
               same_bits_share=same_rows / tables.total, sort_ms=sorts,
               sort_bits=ops.bwd_bits(idx.numel(), tables.total),
               sort_ships="cub", segment_ships=SEGMENT,
               kernels_ms_by_segment=by_segment)
    print(f"{name} (B={B}, {F} x {L} lookups, D={tables.D}, {tables.total} "
          f"rows): earlier {turns['earlier'][0]:.4f} / "
          f"{turns['earlier'][1]:.4f} ms, this {turns['this'][0]:.4f} / "
          f"{turns['this'][1]:.4f} ms in turns ({row['speedup']:.3f}x); "
          f"off the f64 sum by {err['earlier']:.3g} / {err['this']:.3g} of "
          f"max(1, max |ref|) (f32 index_add_ "
          f"{err['index_add_ f32']:.3g}); {row['same_bits_share']:.4%} of "
          f"the rows the "
          f"earlier bits; the sorts over {row['sort_bits']} bits: "
          + ", ".join(f"{how} {ms:.4f} ms" for how, ms in sorts.items())
          + "; the kernels at S = "
          + ", ".join(f"{S}: {ms:.4f}" for S, ms in by_segment.items())
          + f" ms, each the ordered sum's bits (CUB and S = {SEGMENT} ship)",
          flush=True)
    return row


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bag_parent_ab: no CUDA device")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    earlier = load_earlier(pathlib.Path(sys.argv[1]).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {}
    _build.build_all([earlier.build,
                      lambda: libs.update(segment_libraries())])
    dev = torch.device("cuda")
    cfg = dataclasses.replace(DLRM_RM2, vocab_sizes=tuple(
        min(v, CUT_ROWS) for v in DLRM_RM2.resolved_vocabs()))
    vocabs = cfg.resolved_vocabs()
    # the backward reads only the tables' shapes
    tables = ops.prepare_tables([torch.empty((v, cfg.embed_dim), device=dev)
                                 for v in vocabs])
    rows = [case(earlier, libs, name, tables, idx, dev)
            for name, idx in batches(vocabs, dev)]
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
