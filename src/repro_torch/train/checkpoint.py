"""Fault-tolerant checkpointing (DESIGN §6), the port's copy of
``repro.train.checkpoint``: the same on-disk format, so that either
package restores the other's files.

Layout:  <dir>/step_<N>/
            manifest.json     step, leaf index (name, key, shard, shape,
                              dtype, checksum), the caller's ``extra``
            shard_<i>.npz     the leaves, ~512 MiB of them a file

* **leaf names** -- the tree is a nest of dicts (keys in sorted order),
  NamedTuples (by field, named ``.`` + the field, as JAX's ``GetAttrKey``
  prints), lists and tuples (by index) over tensors and numpy arrays,
  flattened as ``jax.tree_util`` flattens it: names are the path's keys
  joined by ``/``, and leaf ``i`` of that order is stored as
  ``leaf_<i>``;
* **atomic** -- writes go to ``step_<N>.tmp``, renamed by ``os.replace``
  once every shard and the manifest are written, so a crashed writer
  never corrupts the latest complete checkpoint; a stale ``.tmp`` is
  reclaimed when a ``Checkpointer`` is made;
* **async** -- ``save_async`` copies every leaf to host memory before it
  returns (the caller may update its tensors in place right after) and
  writes on a thread; an exception there re-raises from the next
  ``wait()``, once;
* **self-validating** -- per-leaf sha256 checksums (16 hex digits of the
  leaf's C-order bytes), verified on restore;
* **parallel** -- the checksums, and the shard files, are computed,
  written and read on a pool of threads (``hashlib``, ``zlib`` and file
  I/O release the GIL on large buffers), so a multi-GB tree (a 1B-param
  model's parameters and moments, 15 GB) saves and restores at the
  disk's rate rather than one core's.

``restore`` returns numpy arrays; placing them on a device is the
caller's.  Re-sharding onto a mesh at restore is not ported yet.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

SHARD_BYTES = 512 << 20
THREADS = min(8, os.cpu_count() or 1)


def _parallel(fn, items) -> list:
    """``[fn(x) for x in items]`` on a pool of ``THREADS`` threads."""
    items = list(items)
    if len(items) < 2:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(fn, items))


def _flatten_with_names(tree, prefix=()):
    """``[(name, leaf)]`` in ``jax.tree_util``'s order: dict keys sorted,
    a NamedTuple's fields in order as ``.field``, sequences by index;
    names are the path joined by ``/``."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for k, v in items:
        out += _flatten_with_names(v, prefix + (k,))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        # fill in sorted key order, keep the caller's key order
        got = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf``, never a view of it: a tensor by one copy
    to the CPU (a bool stays bool, a 0-d tensor stays 0-d), an array by
    ``np.array``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _checksum(arr: np.ndarray) -> str:
    # the digest of arr.tobytes() (C order), hashed in place, not copied
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()[:16]


class Checkpointer:
    """Saves and restores trees of arrays under ``directory``, keeping the
    newest ``keep`` steps.  ``last`` describes the newest save: its
    ``step``, ``bytes``, ``snapshot_s`` (the copy to host, on the
    caller's thread) and ``write_s`` (checksums and files, on the writer
    thread for ``save_async``; set once the write is done)."""

    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.last: dict = {}
        self._thread: threading.Thread | None = None
        self._exc: Exception | None = None
        # a killed writer leaves step_<N>.tmp behind: never a valid
        # checkpoint (the rename publishes), so reclaim the disk
        for stale in self.dir.glob("step_*.tmp"):
            shutil.rmtree(stale, ignore_errors=True)

    # ----------------------------- save -----------------------------

    def _snapshot(self, step: int, tree):
        t0 = time.perf_counter()
        named = [(n, _to_host(x)) for n, x in _flatten_with_names(tree)]
        self.last = dict(step=step, bytes=sum(a.nbytes for _, a in named),
                         snapshot_s=time.perf_counter() - t0)
        return named

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        """Synchronous atomic save of a tree of tensors or arrays."""
        self._write(step, self._snapshot(step, tree), extra or {})

    def save_async(self, step: int, tree, extra: dict | None = None) -> None:
        """Copy ``tree`` to host memory, then write it on a thread (after
        the previous async save has finished)."""
        self.wait()
        named = self._snapshot(step, tree)   # before returning

        def run():
            # an exception on a daemon thread would vanish and the save be
            # silently missing: keep it for wait() to raise
            try:
                self._write(step, named, extra or {})
            except Exception as e:   # noqa: BLE001 -- re-raised in wait()
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the async save in flight; re-raise its exception, if any,
        here on the caller's thread (once)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError(
                "async checkpoint save failed (raised on the writer "
                "thread)") from exc

    def _write(self, step: int, named: list, extra: dict) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = dict(step=step, extra=extra, time=time.time(),
                        leaves=[], shards=0)
        sums = _parallel(_checksum, [leaf for _, leaf in named])
        shards, cur_bytes = [{}], 0
        for i, ((name, leaf), digest) in enumerate(zip(named, sums)):
            key = f"leaf_{i}"
            manifest["leaves"].append(dict(
                name=name, key=key, shard=len(shards) - 1,
                shape=list(leaf.shape), dtype=str(leaf.dtype), sum=digest))
            shards[-1][key] = leaf
            cur_bytes += leaf.nbytes
            if cur_bytes >= SHARD_BYTES:
                shards.append({})
                cur_bytes = 0
        shards = [sh for sh in shards if sh]
        _parallel(lambda i: np.savez(tmp / f"shard_{i}.npz", **shards[i]),
                  range(len(shards)))
        manifest["shards"] = len(shards)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():  # a re-save of the same step (e.g. after resume)
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()
        self.last["write_s"] = time.perf_counter() - t0

    def _gc(self) -> None:
        for s in sorted(self.all_steps())[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------- restore ----------------------------

    def all_steps(self) -> list:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if p.is_dir() and (p / "manifest.json").exists()]

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, tree_like, step: int | None = None,
                shardings=None, verify: bool = True):
        """``(tree, extra, step)``: the leaves of ``step`` (default the
        latest) as numpy arrays in the structure of ``tree_like``, matched
        by name; raises ``IOError`` on a checksum mismatch.
        ``shardings`` ``(mesh, specs)``, ``specs`` a spec a leaf in
        ``tree_like``'s structure (e.g. ``lm_param_shardings``; a spec
        names no mesh, so the pair does), restores the tree laid out over
        the mesh (JAX's ``device_put`` of each leaf): a
        ``dist.sharding.Placed`` of this process's ranks' blocks, each
        ``shard_block`` of the whole leaf, on the mesh's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        metas = [by_name[name] for name, _ in _flatten_with_names(tree_like)]
        wanted: dict = {}
        for meta in metas:
            wanted.setdefault(meta["shard"], []).append(meta["key"])

        def load(sid):
            with np.load(d / f"shard_{sid}.npz") as z:
                return {k: z[k] for k in wanted[sid]}
        arrays = {}
        for got in _parallel(load, sorted(wanted)):
            arrays.update(got)
        out = [arrays[meta["key"]] for meta in metas]
        if verify:
            for meta, arr, digest in zip(metas, out,
                                         _parallel(_checksum, out)):
                if digest != meta["sum"]:
                    raise IOError(f"checksum mismatch for {meta['name']} "
                                  f"@ step {step}")
        tree = _unflatten(tree_like, iter(out))
        if shardings is not None:
            from repro_torch.dist.sharding import lay_out
            if not (isinstance(shardings, tuple) and len(shardings) == 2):
                raise TypeError("shardings must be (mesh, specs)")
            tree = lay_out(tree, *shardings)
        return tree, manifest["extra"], step
