"""Training-side utilities of the port.  So far only the checkpointer
(:mod:`repro_torch.train.checkpoint`), which the streaming engine's
durable state rides on (DESIGN §6, §9)."""
from repro_torch.train.checkpoint import Checkpointer

__all__ = ["Checkpointer"]
