"""Causal GQA flash-attention forward, online softmax in f32 (CUDA,
``csrc/``)."""
