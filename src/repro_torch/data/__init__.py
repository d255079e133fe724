"""Synthetic inputs of the model families (graphs, recsys and LM batches)
and the recorded engine fingerprints of the JAX engine
(``fingerprint_32x32.json``, ``paper_ci_fingerprint.json``,
``skew_fingerprint.json``; ``tools/record_torch_fingerprint.py``)."""
