"""``repro_torch.serving`` — the continuous-batching engine (port of
``repro.serving``; its traffic harness is ported in a later slice, ROADMAP
§1 item 5)."""

from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["ServingEngine", "Request"]
