"""Composite query-batched apps (DESIGN §10).

``batch_app`` lifts Q scalar :class:`DiffusionApp`s into one composite
whose relax, edge_value, propagate_on_insert and fwd_merge act on the
whole ``[..., Q]`` value vector (``repro/mq/app.py``).  Each slot keeps
its own monotone frame: its relax direction, edge semiring and neutral
element, so a mixed BFS + SSSP + CC + widest batch rides one wave, and a
slot whose payload is its neutral element does nothing.

Here each function is one elementwise expression over the vector,
selecting each slot's operation by its app's ``code``: every operation
is the same single IEEE operation the slot's own app does, so a slot
equals its app bit for bit.  The slot codes are also what the cycle
kernel takes, as a table per launch: a new mix of slot apps needs no new
kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.apps import (APPS, BFS, CC, INGEST_ONLY, RELIABLE,
                                   SSSP, WIDEST, DiffusionApp, INF)


@functools.cache
def _masks(codes: tuple, device: torch.device) -> dict:
    """``{app name: [Q] bool}``: the slots each bundled app holds."""
    c = torch.tensor(codes, dtype=torch.int32, device=device)
    return {a.name: c == a.code
            for a in (BFS, SSSP, CC, INGEST_ONLY, WIDEST, RELIABLE)}


def _is_max(k):
    return k["widest"] | k["reliable"]


def _relax(codes):
    def relax(vals, incoming):
        # vals, incoming [..., Q]: a min- or max-relax a slot (ingest_only
        # none), changed where the slot's value moves
        k = _masks(codes, vals.device)
        changed = (torch.where(_is_max(k), incoming > vals, incoming < vals)
                   & ~k["ingest_only"])
        return torch.where(changed, incoming, vals), changed
    return relax


def _edge_value(codes):
    def edge_value(v, w):
        # v [..., Q] the emission, w [...] the edge weight (shared)
        k = _masks(codes, v.device)
        w = torch.as_tensor(w, dtype=v.dtype, device=v.device)[..., None]
        out = torch.where(k["bfs"], v + 1.0, v)
        out = torch.where(k["sssp"], v + w, out)
        out = torch.where(k["widest"], torch.minimum(v, w), out)
        return torch.where(k["reliable"], v * w, out)
    return edge_value


def _propagate(codes):
    def propagate_on_insert(vals):
        # an insert propagates where any tenant would: the wave carries
        # the whole vector and does nothing on unreached slots
        k = _masks(codes, vals.device)
        reached = torch.where(_is_max(k), vals > 0.0, vals < INF)
        return (reached & ~k["ingest_only"]).any(dim=-1)
    return propagate_on_insert


def _fwd_merge(codes):
    def fwd_merge(fv, inc):
        # each slot's meet: max for the max-monotone apps, else min
        k = _masks(codes, fv.device)
        return torch.where(_is_max(k), torch.maximum(fv, inc),
                           torch.minimum(fv, inc))
    return fwd_merge


def batch_app(slot_apps, name: str | None = None) -> DiffusionApp:
    """Compose Q slot apps (names of ``core.apps.APPS`` or the apps
    themselves, each a scalar app) into one ``qbatch = Q`` app.  Q = 1
    returns the slot's own app."""
    apps = tuple(APPS[a] if isinstance(a, str) else a for a in slot_apps)
    if not apps:
        raise ValueError("batch_app needs at least one slot app")
    for a in apps:
        if a.n_vals != 1 or a.qbatch != 1 or APPS.get(a.name) != a:
            raise ValueError(f"slot app {a.name!r} must be one of the "
                             f"scalar apps {sorted(APPS)}")
    if len(apps) == 1:
        return apps[0]
    codes = tuple(a.code for a in apps)
    # the host's root combine is per slot (MQSession passes each slot's
    # to engine.values); the composite's covers whole-vector uses only
    return DiffusionApp(
        name=name or ("mq[" + ",".join(a.name for a in apps) + "]"),
        code=-1, relax=_relax(codes), edge_value=_edge_value(codes),
        propagate_on_insert=_propagate(codes),
        init_val=tuple(float(a.init_val) for a in apps),
        n_vals=len(apps), combine=apps[0].combine,
        fwd_merge=_fwd_merge(codes),
        fwd_neutral=tuple(float(a.fwd_neutral) for a in apps),
        qbatch=len(apps), slot_apps=apps)
