"""Logging of negotiation and stream events (the reference's ACM message
logfile, AC3ACM_LOGFILE).  The profiler switch (torch.profiler) is not
ported yet (ROADMAP A11)."""
from __future__ import annotations

import logging

log = logging.getLogger("ac3acm_tpu_torch")


def setup_logging(path: str | None = None, level=logging.INFO):
    """AC3ACM_LOGFILE analogue: structured log of negotiation/stream events."""
    handler = (logging.FileHandler(path) if path
               else logging.StreamHandler())
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(handler)
    log.setLevel(level)
    return log


def log_format_negotiation(direction: str, src, dst):
    log.info("format_suggest %s: %s -> %s", direction, src, dst)
