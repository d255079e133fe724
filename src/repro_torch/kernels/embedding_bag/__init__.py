"""EmbeddingBag: gather and reduce of table rows per bag, all fields of a
forward in one launch (CUDA, ``csrc/``)."""
