"""Codec driver facade — the ACM `DriverProc` shell rebuilt as one object.

The reference ties everything together in a Windows ACM driver: `DriverProc`
dispatches DRV_*/ACMDM_* messages (AC3ACM.cpp:2479-2540), `drv_open`
allocates per-instance state + config (AC3ACM.cpp:608-693),
`formattag_details`/`format_details` enumerate the 342 AC-3 + PCM formats
(AC3ACM.cpp:1032-1399), `format_suggest` negotiates conversion pairs
(AC3ACM.cpp:751-1029), and `stream_open` validates a pair and builds the
converter instance (AC3ACM.cpp:1856-2105).

`CodecDriver` is the platform-neutral equivalent: one facade over the
format model, negotiation rules, config persistence, and the streaming
converters in `io/stream.py`.  There are no OS messages to dispatch — each
message becomes a method — but the lifecycle shape (driver open -> query
formats -> suggest -> stream open -> convert loop -> close) is preserved so
ACM-style hosts map one-to-one.  A copy of the JAX package's driver whose
streams convert on `device` (None: the CUDA card, raising without one;
"cpu" runs the plain PyTorch versions).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..utils.config import CodecConfig
from ..utils.trace import log
from .stream import (Ac3Format, Ac3ToPcmStream, PcmFormat, PcmToAc3Stream,
                     enumerate_ac3_formats, stream_copy, stream_size,
                     suggest_ac3, suggest_pcm)

# enumeration order follows the AC-3 format list (48k first,
# enumerate_ac3_formats), matching the ACM driver's display ordering
SAMPLE_RATES = (48000, 44100, 32000)


@dataclass(frozen=True)
class FormatTagDetails:
    """One conversion-format tag (formattag_details, AC3ACM.cpp:1032-1178)."""
    tag: str                 # "pcm" | "ac3"
    n_formats: int
    name: str


def _fmt_name(fmt) -> str:
    """Display string, format_details parity (AC3ACM.cpp:1181-1399)."""
    if isinstance(fmt, Ac3Format):
        return (f"{fmt.sample_rate} Hz, {fmt.channels} ch, "
                f"{fmt.bitrate} kbit/s AC-3")
    return f"{fmt.sample_rate} Hz, {fmt.channels} ch, {fmt.bits}-bit PCM"


class StreamInstance:
    """One open conversion stream (MyStreamData analogue, AC3ACM.cpp:92-102).

    Owns the converter and the partial-frame carry; `convert` is the
    ACMDM_STREAM_CONVERT equivalent, `size` is ACMDM_STREAM_SIZE.
    """

    def __init__(self, src, dst, cfg: CodecConfig, device=None):
        self.src, self.dst, self.cfg = src, dst, cfg
        self._driver = None          # set by CodecDriver.stream_open
        self._closed = False
        if isinstance(src, Ac3Format) and isinstance(dst, PcmFormat):
            self._conv = Ac3ToPcmStream(dst_channels=dst.channels, cfg=cfg,
                                        device=device)
            self._mode = "decode"
        elif isinstance(src, PcmFormat) and isinstance(dst, Ac3Format):
            self._conv = PcmToAc3Stream(dst, cfg=cfg, device=device)
            self._mode = "encode"
        else:
            # same-type pair: bounded passthrough (stream_copy,
            # AC3ACM.cpp:1801-1826)
            self._conv = None
            self._mode = "copy"
        log.info("stream_open %s: %s -> %s", self._mode, src, dst)

    @property
    def mode(self) -> str:
        return self._mode

    def convert(self, data):
        """Feed source data, get converted output.

        decode: bytes -> interleaved int16 [n, nch]
        encode: int16 [n, nch] -> AC-3 bytes
        copy:   bytes -> bytes
        """
        if self._closed:
            raise RuntimeError("convert() on a closed stream")
        if self._mode == "copy":
            return stream_copy(bytes(data))
        return self._conv.convert(data)

    def size(self, src_len: int, query_source: bool = True) -> int:
        """Worst-case destination (or source) buffer size
        (ACMDM_STREAM_SIZE, AC3ACM.cpp:2139-2363)."""
        if self._mode == "copy":
            return src_len
        ac3 = self.src if self._mode == "decode" else self.dst
        pcm = self.dst if self._mode == "decode" else self.src
        return stream_size(self._mode == "decode", src_len, ac3, pcm,
                           query_source)

    def close(self):
        """ACMDM_STREAM_CLOSE: release the converter and deregister from
        the owning driver (the reference frees MyStreamData here)."""
        self._conv = None
        self._closed = True
        if self._driver is not None:
            try:
                self._driver._streams.remove(self)
            except ValueError:
                pass
            self._driver = None


class CodecDriver:
    """The driver: config + format model + negotiation + stream factory.

    Mirrors the DriverProc lifecycle (AC3ACM.cpp:2479-2540):
      DRV_OPEN            -> CodecDriver(cfg)     (drv_open, :608)
      ACMDM_FORMATTAG_DETAILS -> formattag_details()
      ACMDM_FORMAT_DETAILS    -> format_details(tag)
      ACMDM_FORMAT_SUGGEST    -> format_suggest(src)
      ACMDM_STREAM_OPEN       -> stream_open(src, dst)
      DRV_CONFIGURE           -> configure(...) / save_config()
      DRV_CLOSE               -> close()
    """

    #: driver identity strings (AC3ACM.rc version block parity)
    NAME = "AC-3 ACM Codec (PyTorch/CUDA)"
    VERSION = "2.2"

    def __init__(self, cfg: CodecConfig | None = None,
                 config_path: str | None = None, device=None):
        self.config_path = config_path
        self.device = device
        self.cfg = cfg or CodecConfig.load(config_path)
        self._streams: list[StreamInstance] = []
        log.info("driver open: %s v%s cfg=%s", self.NAME, self.VERSION,
                 self.cfg)

    # -- format enumeration ------------------------------------------------

    def formattag_details(self) -> list[FormatTagDetails]:
        """Both conversion tags with their standard-format counts
        (342 AC-3 = 3 rates x 6 ch x 19 bitrates; 18 PCM = 3 rates x 6 ch)."""
        return [
            FormatTagDetails("pcm", len(self.format_details("pcm")), "PCM"),
            FormatTagDetails("ac3", len(self.format_details("ac3")),
                             "Dolby AC-3"),
        ]

    def format_details(self, tag: str):
        """Every standard format under a tag, in enumeration order
        (format_details, AC3ACM.cpp:1181-1399)."""
        if tag == "ac3":
            return list(enumerate_ac3_formats())
        if tag == "pcm":
            return [PcmFormat(ch, rate) for rate in SAMPLE_RATES
                    for ch in range(1, 7)]
        raise ValueError(f"unknown format tag {tag!r}")

    def format_name(self, fmt) -> str:
        return _fmt_name(fmt)

    def is_valid(self, fmt) -> bool:
        """IsValidPCM / IsValidAC3 (AC3ACM.cpp:207-353)."""
        return fmt.is_valid()

    # -- negotiation -------------------------------------------------------

    def format_suggest(self, src):
        """Suggest the counterpart format for a conversion
        (format_suggest, AC3ACM.cpp:751-1029): AC-3 -> PCM honours the
        multichannel config (stereo downmix preference); PCM -> AC-3 picks
        the 64/96 kbps-per-channel default bitrate."""
        if isinstance(src, Ac3Format):
            return suggest_pcm(src, self.cfg)
        if isinstance(src, PcmFormat):
            return suggest_ac3(src, self.cfg)
        raise TypeError(f"unsupported source format {src!r}")

    # -- streams -----------------------------------------------------------

    def stream_open(self, src, dst) -> StreamInstance:
        """Validate the pair and build a converter (stream_open,
        AC3ACM.cpp:1856-2105).  Sample rates must match — the reference
        refuses resampling conversions (AC3ACM.cpp:1875-1889) — and the
        channel layouts must be a pair the converters actually produce:
        decode to mono, stereo, or the coded channel count; encode with
        the PCM channel count the AC-3 format will code."""
        if not (self.is_valid(src) and self.is_valid(dst)):
            raise ValueError(f"invalid conversion pair {src} -> {dst}")
        if src.sample_rate != dst.sample_rate:
            raise ValueError("sample rates must match "
                             f"({src.sample_rate} != {dst.sample_rate})")
        same_type = type(src) is type(dst)
        if same_type and src != dst:
            raise ValueError(f"same-type pair must match exactly for "
                             f"stream_copy: {src} != {dst}")
        if isinstance(src, Ac3Format) and isinstance(dst, PcmFormat):
            if dst.channels not in (1, 2, src.channels):
                raise ValueError(
                    f"decode to {dst.channels} ch unsupported for a "
                    f"{src.channels}-ch stream (mono/stereo/native only)")
            if dst.channels > 2 and not self.cfg.multichannel:
                raise ValueError("multichannel output disabled by config "
                                 "(MULTICHANNEL flag)")
        if isinstance(src, PcmFormat) and isinstance(dst, Ac3Format):
            if src.channels != dst.channels:
                raise ValueError(
                    f"encode channel mismatch: {src.channels}-ch PCM -> "
                    f"{dst.channels}-ch AC-3")
        inst = StreamInstance(src, dst, self.cfg, self.device)
        inst._driver = self
        self._streams.append(inst)
        return inst

    # -- config ------------------------------------------------------------

    def configure(self, **updates) -> CodecConfig:
        """DRV_CONFIGURE analogue: update flags on the live config
        (MyDialogProc commits the checkbox states, AC3ACM.cpp:2366-2451)."""
        import dataclasses
        self.cfg = dataclasses.replace(self.cfg, **updates)
        log.info("driver configure: %s", updates)
        return self.cfg

    def save_config(self, path: str | None = None):
        """WriteReg analogue (AC3ACM.cpp:568-592)."""
        p = path or self.config_path
        if not p:
            raise ValueError("no config path")
        self.cfg.save(p)

    def close(self):
        for s in list(self._streams):     # s.close() deregisters itself
            s.close()
        self._streams.clear()
        log.info("driver close")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
