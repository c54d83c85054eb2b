"""The request-status taxonomy (counterpart of `repro/serve/slo.py`).

Only the terminal status the base serving path reaches is ported; the SLO
policy, shedding and the degradation ladder are ROADMAP Queue A item 8.
"""
from __future__ import annotations

import enum


class RequestStatus(str, enum.Enum):
    """Terminal state of one request. Exactly one per submitted rid."""

    #: ran to completion (EOS or length cap)
    OK = "ok"
