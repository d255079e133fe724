"""Hand-written Hopper kernels, one directory per kernel: ``csrc/`` (the
CUDA source), ``ops.py`` (wrapper: builds, checks, launches, counts) and
``ref.py`` (the plain PyTorch version).  ``_build.py`` is their shared
nvcc-to-ctypes build.

  cca_cycle/        fused cycle kernel: K engine cycles per launch
  spmm/             scatter-SpMM: segment sum of edge messages over CSR
  embedding_bag/    EmbeddingBag: all fields of a DLRM batch in one launch
  flash_attention/  causal GQA attention forward, online softmax in f32
"""
from __future__ import annotations

import importlib

KERNELS = ("cca_cycle", "spmm", "embedding_bag", "flash_attention")


def build_all():
    """Build every kernel, one nvcc each, all started together; ``(library
    path, ptxas report)`` in the order of ``KERNELS``."""
    from repro_torch.kernels import _build
    return _build.build_all([
        importlib.import_module(f"repro_torch.kernels.{name}.ops").build
        for name in KERNELS])
