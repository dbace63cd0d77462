"""ac3acm_tpu_torch: the AC-3 (ATSC A/52) decode path in PyTorch and CUDA.

The port of ``ac3acm_tpu`` to one NVIDIA H100.  This slice holds the
batched decode main path in fast mode:

  host.native          native C++ dense parser (own copy of the runtime)
  models.decoder       steady decode math, StreamFormat, accuracy policy
  ops.fused_steady     the fused steady kernel (CUDA, csrc/) + plain twin
  parallel.pipeline    batched_pipeline, BatchedDecoder(parser="native")
  utils.state          carry checkpoint / resume

Entry points run on the CUDA card unless the caller passes device="cpu".
Kernels build at first use, never at import.
"""

__version__ = "0.1.0"

from . import tables  # noqa: F401


def set_accuracy(mode: str):
    """Package decode accuracy policy: "reference" (default; the
    order-exact IMDCT, not ported yet -- pipelines raise) or "fast"
    (matmul / fused filterbank, max<=0.02 mean<=0.001 sigma<=0.002 in
    16-bit units).  Set before building decoders."""
    from .models.decoder import set_accuracy as _set
    _set(mode)


__all__ = ["tables", "set_accuracy"]
