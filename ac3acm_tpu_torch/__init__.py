"""ac3acm_tpu_torch: the AC-3 (ATSC A/52) codec in PyTorch and CUDA.

The port of ``ac3acm_tpu`` to one NVIDIA H100.  It holds the batched
decode in both accuracy modes, the Python parser, the single-stream
decode, the encoder and the transcoder:

  host.native          native C++ parsers (dense, side-info, one stream)
                       and the native CPU decoder (own copy of the runtime)
  host.parse           the Python parser A52Parser (+ host.alloc,
                       host.bitio), syncinfo, downmix negotiation
  models.decoder       the steady and block-scan decode bodies,
                       StreamFormat, accuracy policy, the single-stream
                       Decoder
  ops.imdct_exact      the order-exact IMDCT kernel (CUDA, csrc/) + plain twin
  ops.fused_steady     the fused steady kernel (CUDA, csrc/) + plain twin
  ops.unpack_device    the raw-H2D bitstream unpack (gathers: ops.bitgather)
  parallel.pipeline    batched_pipeline, raw_batched_pipeline,
                       BatchedDecoder(parser="native" | "raw" | "python"
                       | "raw_py")
  models.encoder       the frame encoder (ops.mdct, the rate model of
                       ops.alloc), Encoder
  ops.pack_device      frame assembly on the device (host.pack: on the host)
  parallel.encode      BatchedEncoder(pack="device" | "native")
  parallel.transcode   Transcoder(parser="native" | "raw"),
                       transcode_pipeline(_multi)
  io.stream            the ACM-shell format model, Ac3ToPcmStream and
                       PcmToAc3Stream
  a52                  the a52_* decode API (on the native CPU decoder) and
                       AC3_encode_init / AC3_encode_frame
  utils.state          decoder carry, parser state and encoder carry
                       checkpoint / resume

Entry points run on the CUDA card unless the caller passes device="cpu".
Kernels build at first use, never at import.
"""

__version__ = "0.1.0"

from . import tables  # noqa: F401


def set_accuracy(mode: str):
    """Package decode accuracy policy: "reference" (default; the
    order-exact IMDCT, bit-identical to the compiled float liba52) or
    "fast" (matmul / fused filterbank, max<=0.02 mean<=0.001 sigma<=0.002
    in 16-bit units).  Set before building decoders."""
    from .models.decoder import set_accuracy as _set
    _set(mode)


__all__ = ["tables", "a52", "set_accuracy"]
