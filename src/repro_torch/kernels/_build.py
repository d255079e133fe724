"""nvcc-to-ctypes build shared by the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  It is
compiled by ``nvcc`` into a shared library at first use, under
``build/<hash of source and flags>/`` beside the kernel's ``ops.py``, and
loaded with ``ctypes`` by that wrapper.  A build already on disk for the
same source and flags is reused.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import os
import pathlib
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
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
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


def build_all(builds) -> list[tuple[pathlib.Path, str]]:
    """Run several kernels' ``build()`` functions at once (one nvcc each,
    all started together); results in the order given."""
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = [pool.submit(b) for b in builds]
        return [f.result() for f in futures]
