"""What the harness's process may not hold: JAX, or the JAX package.

Top-level module names are compared whole: ``ac3acm_tpu_torch`` begins
with ``ac3acm_tpu`` and is the program, not the JAX package."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ac3acm_tpu")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (default: every module
    this process has loaded)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))
