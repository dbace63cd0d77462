"""Runtime configuration.

The reference keeps persistent options in a registry DWORD of bit flags
(AC3ACM.cpp:75-84: MULTICHANNEL, DYNAMICRANGE, DOLBYSURROUND, DONTUSEMMX,
USE64, NOEXTENSIBLE) plus compile-time dtype policy.  Here it is a
dataclass, loadable from a JSON file or the AC3TPU_CONFIG path.
"""
from __future__ import annotations

import dataclasses
import json
import os

from .. import tables as T


@dataclasses.dataclass
class CodecConfig:
    multichannel: bool = True        # decode to >2 channels when available
    dynamic_range: bool = True       # apply dynrng compression
    dolby_surround: bool = False     # prefer Dolby 2-ch downmix
    extensible_formats: bool = True  # WAVEFORMATEXTENSIBLE-style formats
    default_bitrate_per_channel: int = 96   # kbit/s per channel
    dtype_policy: str = "float32"    # the float/fixed compile axis

    # decode-output request derived from the flags (ACM shell behaviour,
    # AC3ACM.cpp:1519-1550): multichannel off -> stereo/dolby
    def output_flags(self, coded_flags: int) -> int:
        if not self.multichannel:
            return T.A52_DOLBY if self.dolby_surround else T.A52_STEREO
        return coded_flags

    def default_bitrate(self, channels: int) -> int:
        """Encode default: 64 kbps/ch for mono/stereo, 96 for multichannel
        (format_suggest behaviour, AC3ACM.cpp:751-1029)."""
        per = 64 if channels <= 2 else 96
        return per * channels * 1000

    @classmethod
    def load(cls, path: str | None = None) -> "CodecConfig":
        path = path or os.environ.get("AC3TPU_CONFIG")
        if path and os.path.exists(path):
            with open(path) as f:
                return cls(**json.load(f))
        return cls()

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
