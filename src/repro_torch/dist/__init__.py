"""repro_torch.dist -- the distribution layer (DESIGN §5), the port of
``repro.dist``:

* :mod:`repro_torch.dist.ctx`       -- the mesh and its registry
* :mod:`repro_torch.dist.sharding`  -- per-family sharding rules as spec
  tuples, ``pad_to``
* :mod:`repro_torch.dist.transport` -- ``LocalTiles`` and
  ``ProcessGroupTiles``: halo exchanges and reductions
* :mod:`repro_torch.dist.cca`       -- the sharded engine: tiles, halos,
  the per-cycle exchange
* :mod:`repro_torch.dist.pipeline`  -- microbatch pipeline parallelism

The JAX package's ``dist/compat.py`` (JAX version shims) has no
counterpart: nothing in PyTorch needs one.
"""
