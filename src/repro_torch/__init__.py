"""PyTorch and CUDA port of the streaming dynamic graph engine (``repro``).

Laid out module for module like the JAX package, which stays the
reference.  The port imports neither JAX nor anything of ``repro``; its
entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``.
"""
