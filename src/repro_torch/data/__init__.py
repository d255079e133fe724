"""Synthetic inputs of the model families (graphs, recsys and LM batches)
and the recorded engine fingerprint (``fingerprint_32x32.json``)."""
