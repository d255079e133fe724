"""nvcc-to-ctypes build shared by the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (it may
include headers beside it in ``csrc/``).  It is compiled by ``nvcc`` into
a shared library at first use, under ``build/<hash>/`` beside the
kernel's ``ops.py``, the hash taken over every file in ``csrc/`` (names
and contents) and the flags, and loaded with ``ctypes`` by that wrapper.
A build already on disk for the same sources and flags is reused.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

# the flags every kernel shares; a kernel may add its own
SM90A_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use")


def build(source: pathlib.Path, flags: tuple[str, ...]
          ) -> tuple[pathlib.Path, str]:
    """Compile ``source`` with ``flags`` unless that build exists.
    Returns ``(library path, nvcc's -Xptxas -v report)``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(p for p in source.parent.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(source.parent)).encode() + b"\0")
        h.update(f.read_bytes())
    digest = h.hexdigest()
    out = (source.parent.parent / "build" / digest[:16]
           / f"lib{source.stem}.so")
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return out, log.read_text()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{os.getpid()}.so")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, out)
    return out, report


def ptxas_functions(report: str) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {registers, stack, spill_stores, spill_loads,
    smem}} from an ``-Xptxas -v`` report, the keys each function's lines
    give."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m[1])
    return out


def build_all(builds) -> list[tuple[pathlib.Path, str]]:
    """Run several kernels' ``build()`` functions at once (one nvcc each,
    all started together); results in the order given."""
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = [pool.submit(b) for b in builds]
        return [f.result() for f in futures]
