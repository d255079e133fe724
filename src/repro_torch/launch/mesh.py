"""Host mesh construction (the port of ``repro.launch.mesh``).

``make_host_mesh(data, model)`` is the ``(data, model)`` mesh of the
tests and of one card: by default its ranks are tiles on one device
(``LocalTiles``); pass ``transport=ProcessGroupTiles(...)`` for one rank
a process.  The JAX package's ``make_production_mesh`` (the 256- and
512-chip TPU pods) waits for ROADMAP queue 1 item 9, with the dry run.
"""
from __future__ import annotations

from repro_torch.dist.ctx import Mesh


def make_host_mesh(data: int = 1, model: int = 1, transport=None,
                   device=None) -> Mesh:
    """A ``(data, model)`` mesh.  Without ``transport``, its ranks are
    ``LocalTiles`` on ``device`` (``None``: the card)."""
    if transport is None:
        from repro_torch.dist.transport import LocalTiles
        transport = LocalTiles(data * model, device=device)
    return Mesh((data, model), ("data", "model"), transport)


def dp_axes(mesh) -> tuple:
    """The data-parallel axis group: ('pod','data') when a pod axis
    exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
