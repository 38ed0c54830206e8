"""Online row updates for a live Session: the request type (port of
``repro.core.online``, its ``Update`` dataclass).

``Session.solve(Update(rows, responses))`` will absorb an (m, p) row
block into the session's device-resident problem state and re-solve warm.
This slice ports the request and its admission checks only; the session
refuses it, naming ROADMAP A6.3, which brings ``OnlineState``,
``apply_update`` and the Gram block update.

Module scope stays numpy and stdlib only (the lazy public surface).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["Update"]


@dataclasses.dataclass(frozen=True)
class Update:
    """Streaming request: absorb an (m, p) row block, then re-solve warm.

    ``lam`` defaults to the session's last solved lambda; ``window``
    (fixed at stream entry) turns the stream into a sliding window of
    the most recent ``window`` rows; ``resolve=False`` applies the
    update without re-solving.
    """
    rows: Any
    responses: Any
    lam: Optional[float] = None
    window: Optional[int] = None
    resolve: bool = True
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        from repro_torch.core.serving import validate_request
        validate_request(self)
