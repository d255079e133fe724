"""repro_torch.mq -- multi-tenant query serving over one evolving graph.

The port of ``repro.mq`` (DESIGN §10): the vertex value slot carries one
value per concurrent query, app-like messages widen to vector payloads,
and one relaxation wave over the live structure serves every tenant.

  batch_app   the composite :class:`DiffusionApp` over Q slot apps
  MQSession   the serving engine: admit / run / read back / retire queries
  FrontDesk   admission control and per-query latency accounting
"""
from repro_torch.mq.app import batch_app
from repro_torch.mq.frontdesk import FrontDesk, QueryRequest
from repro_torch.mq.session import MQSession, QuerySlot

__all__ = ["batch_app", "MQSession", "QuerySlot", "FrontDesk",
           "QueryRequest"]
