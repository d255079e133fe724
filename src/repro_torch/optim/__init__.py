"""Optimizer and gradient compression of the port (``repro.optim``):
AdamW with its schedule and global-norm clipping, and int8 block
compression with error feedback."""
