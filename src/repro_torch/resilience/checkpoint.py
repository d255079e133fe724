"""Durable streaming state: engine <-> ``train.checkpoint`` glue (DESIGN
§9), the port's copy of ``repro.resilience.checkpoint``.

``StreamingEngine.checkpoint`` / ``.restore`` route the whole
``MachineState``, the stream cursor and a config fingerprint through
:class:`repro_torch.train.checkpoint.Checkpointer` (tmp-and-rename
publish, async writer thread, per-leaf checksums).  This module holds the
fingerprint and the manifest's ``extra`` dict.

The fingerprint covers every config field, the nested ``FaultPlan``
included: restoring under another config would reinterpret the address
and queue layout silently, so ``restore`` refuses a mismatch unless told
``strict=False``.  It hashes the JAX package's field set, so that the
same config gives the same digest in both packages: the port's config
has no ``backend`` field, so ``backend`` is hashed as ``"jnp"`` unless
another value is asked for.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

CKPT_KIND = "cca_stream"
# the JAX engine's backends: both run one state layout bit-exactly
JAX_BACKENDS = ("jnp", "pallas")


def config_fingerprint(cfg, backend: str = "jnp") -> str:
    """Stable 16-hex-digit digest of every config field (nested
    dataclasses included) and ``backend``, equal to the JAX package's
    ``config_fingerprint`` of the same config under that backend."""
    d = dataclasses.asdict(cfg)
    d.setdefault("backend", backend)
    blob = json.dumps(d, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def stream_manifest(engine) -> dict:
    """The ``extra`` dict saved beside the state's leaves: all the host
    driver needs to resume mid-stream bit-exactly."""
    return dict(
        kind=CKPT_KIND,
        config=config_fingerprint(engine.cfg),
        app=engine.app.name,
        stream_pos=engine.stream_pos,
        total_cycles=engine.total_cycles,
        totals=dict(engine.totals),
    )
