"""Throughput meter: frames/sec and realtime factor.

Parity with the reference CLI's print_fps (a52dec.c:70-120): periodic rate
plus a final average; 1 frame = 1536 samples, so realtime at 48 kHz is
31.25 fps.  Extended with the aggregate x-realtime figure (frames of all
streams together).  A copy of the JAX package's meter.
"""
from __future__ import annotations

import sys
import time


class FpsMeter:
    def __init__(self, sample_rate: int = 48000, period: float = 0.5,
                 out=None, enabled: bool = True):
        self.sample_rate = sample_rate
        self.period = period
        self.out = out
        self.enabled = enabled
        self.t0 = self.tlast = time.perf_counter()
        self.frames = 0
        self.frames_last = 0

    def tick(self, frames: int = 1, streams: int = 1):
        self.frames += frames * streams
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self.tlast >= self.period:
            fps = (self.frames - self.frames_last) / (now - self.tlast)
            print(f"\r{fps:.1f} frames/sec, {self._xrt(fps):.1f}x realtime ",
                  end="", file=self.out or sys.stderr, flush=True)
            self.tlast = now
            self.frames_last = self.frames

    def _xrt(self, fps: float) -> float:
        return fps * 1536 / self.sample_rate

    def close(self):
        dt = time.perf_counter() - self.t0
        if dt <= 0 or self.frames == 0:
            return
        fps = self.frames / dt
        if self.enabled:
            print(f"\n{self.frames} frames in {dt:.2f}s "
                  f"({fps:.1f} fps, {self._xrt(fps):.1f}x realtime)",
                  file=self.out or sys.stderr)
