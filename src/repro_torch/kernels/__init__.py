"""Hand-written Hopper kernels, one directory per kernel: ``csrc/`` (the
CUDA source), ``ops.py`` (wrapper: builds, checks, launches, counts) and
``ref.py`` (the plain PyTorch version).  ``_build.py`` is their shared
nvcc-to-ctypes build.

  cca_cycle/      fused cycle kernel: K engine cycles per launch
  spmm/           scatter-SpMM: segment sum of edge messages over CSR
  embedding_bag/  EmbeddingBag: all fields of a DLRM batch in one launch
"""
