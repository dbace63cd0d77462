"""The port's spans and counters (utils/trace.py): off, they record nothing
and never enter the profiler; under profile() every span of the raw
decode, of the raw transcode and of the batched encode is recorded, once
a stretch, with its chunk's step, and shows in the Chrome trace as an
``ac3.<name>`` annotation; StageClock keeps its stage names; feed counts
the bytes it copies, the encoder the bytes it stages; a library's first
load counts its seconds."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu_torch.ops import _cuda
from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder, StageClock
from ac3acm_tpu_torch.parallel.transcode import Transcoder
from ac3acm_tpu_torch.utils import trace
from benchmark.core.spec import BENCH

FLAGS = 2 | 0x10                        # A52_STEREO | A52_ADJUST_LEVEL
DECODE_SPANS = {"feed", "sideinfo_parse", "chunk_assembly", "prune_plan",
                "h2d", "unpack.exponents", "unpack.alloc",
                "unpack.mantissas", "tail"}
TRANSCODE_SPANS = DECODE_SPANS | {"encode", "finish.wait", "finish.bytes"}
ENCODE_SPANS = {"enc.stage", "enc.h2d", "enc.run", "enc.wait", "enc.bytes"}
STAGES = ["host side-info parse", "chunk assembly", "prune + plan probes",
          "H2D copy", "device unpack", "steady tail + int16"]


@pytest.fixture(scope="module")
def frames():
    return CS.golden_frames(CS.GOLDEN)


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.reset()


def _decoder():
    return BatchedDecoder(2, FLAGS, 1.0, 384.0, emit_int16=True,
                          parser="raw", device="cpu")


def _decode(frames, bd, chunks=2, clock=None):
    """`chunks` steps of one frame a lane (lane 1 a frame ahead)."""
    out = []
    for k in range(chunks):
        for lane in range(2):
            bd.feed(lane, frames[k + lane])
        pcm, valid = bd.decode_available(1, clock=clock)
        assert valid.all()
        out.append(pcm)
    return out


def _profiled(tmp_path, work):
    """work() under profile(): -> (its result, the Chrome trace's
    events)."""
    with trace.profile(str(tmp_path)):
        r = work()
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(path) as f:
        return r, json.load(f)["traceEvents"]


def _check(spans, events, names):
    """Every name in every step, no two spans overlapping, and one
    user_annotation in the trace for each span in memory."""
    by_step = {}
    for name, step, _, _ in spans:
        by_step.setdefault(step, set()).add(name)
    assert by_step and all(v == names for v in by_step.values()), by_step
    iv = sorted((t0, t1) for _, _, t0, t1 in spans)
    assert all(t0 <= t1 for t0, t1 in iv)
    assert all(b[0] >= a[1] for a, b in zip(iv, iv[1:])), "spans nest"
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation" and \
                str(e.get("name", "")).startswith("ac3."):
            ann[e["name"]] = ann.get(e["name"], 0) + 1
    mem = {}
    for name, _, _, _ in spans:
        mem["ac3." + name] = mem.get("ac3." + name, 0) + 1
    assert ann == mem


def test_off_records_nothing_and_enters_no_profiler(frames, tmp_path,
                                                    monkeypatch):
    on, _ = _profiled(tmp_path, lambda: _decode(frames, _decoder()))
    trace.reset()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = _decode(frames, _decoder())
    assert trace.spans() == [] and trace.counters() == {}
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_decode_spans(frames, tmp_path):
    _, events = _profiled(tmp_path, lambda: _decode(frames, _decoder()))
    spans = trace.spans()
    assert {s[1] for s in spans} == {0, 1}
    _check(spans, events, DECODE_SPANS)
    per_step = {}
    for _, step, t0, t1 in spans:
        per_step[step] = per_step.get(step, 0) + (t1 - t0)
    assert set(per_step) == {0, 1} and all(v > 0 for v in per_step.values())


def test_transcode_spans_carry_their_dispatch_step(frames, tmp_path):
    tc = Transcoder(2, 192000, 2, parser="raw", device="cpu")

    def work():
        # both chunks in flight, as the transcode farm runs them
        hs = [tc.dispatch_frames([frames[k], frames[k + 1]], 1)
              for k in range(2)]
        return [tc.finish(h) for h in hs]
    _, events = _profiled(tmp_path, work)
    spans = trace.spans()
    _check(spans, events, TRANSCODE_SPANS)
    order = [(name, step) for name, step, _, _ in spans
             if name.startswith("finish.")]
    assert order == [("finish.wait", 0), ("finish.bytes", 0),
                     ("finish.wait", 1), ("finish.bytes", 1)]
    # finish(0) runs after dispatch(1): its spans take the handle's step
    t_enc1 = next(t0 for name, step, t0, _ in spans
                  if (name, step) == ("encode", 1))
    assert all(t0 > t_enc1 for name, _, t0, _ in spans
               if name.startswith("finish."))


def test_stage_clock_names_unchanged(frames, tmp_path):
    bd = _decoder()
    _decode(frames, bd, chunks=1)
    clock = StageClock("cpu")
    _profiled(tmp_path, lambda: _decode(frames[1:], bd, 1, clock))
    assert list(clock.seconds) == STAGES
    assert "blocks" in clock.kept and clock.kept["h2d_bytes"] > 0
    # the stage and its span end at the same site: the span is inside it
    spans = {name: (t1 - t0) * 1e-9 for name, _, t0, t1 in trace.spans()}
    assert spans["sideinfo_parse"] <= clock.seconds["host side-info parse"]
    assert spans["h2d"] <= clock.seconds["H2D copy"]


def test_feed_counts_the_buffers_it_builds(frames, tmp_path):
    """feed_copied_bytes of a step: the bytes fed, plus the unconsumed
    bytes that dropping a lane's consumed frames moves.  Step 0 feeds lane
    0 one frame and lane 1 two; the step decodes one frame a lane, so lane
    1 keeps its second.  Step 1 feeds lane 0 two frames (its first feed
    drops the consumed frame, nothing after it) and lane 1 one, whose feed
    moves the frame lane 1 kept."""
    bd = _decoder()

    def work():
        for sizes in ((1, 2), (2, 1)):
            for lane, n in enumerate(sizes):
                for f in range(n):
                    bd.feed(lane, frames[f])
            bd.decode_available(1)
    _profiled(tmp_path, work)
    assert trace.counters()["feed_copied_bytes"] == {0: 1792 * (1 + 2),
                                                     1: 1792 * (2 + 1 + 1)}
    assert [(len(ln.buf), ln.pos) for ln in bd.lanes] == [(3584, 1792)] * 2


def test_first_library_load_counts_its_seconds(monkeypatch):
    """A library's first load adds its seconds to lib_load_s, with no
    profiler; a second load of it adds nothing."""
    from ac3acm_tpu_torch.host import native
    so = native._build()
    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.setattr(_cuda, "build", lambda name: so)
    bound = []
    _cuda.load("probe", bound.append)
    _cuda.load("probe", bound.append)
    assert len(bound) == 1
    c = trace.counters()
    assert set(c) == {"lib_load_s"} and c["lib_load_s"][None] > 0


def test_encoder_spans_and_staged_bytes(tmp_path, monkeypatch):
    """Off, a chunk of BatchedEncoder records nothing and enters no
    profiler; on, the next chunk records the five enc.* spans under its
    step and counts the bytes its frame-major reorder writes."""
    frozen = np.load(os.path.join(BENCH, "data", "a52_51_448_3f2r_lfe.npy"))
    pcm = np.stack([frozen[0, :2].reshape(-1, 6)] * 4)   # [4, 2*1536, 6]
    enc = BatchedEncoder(4, 48000, 640000, 6, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        enc.encode_frames(pcm)
    assert trace.spans() == []
    assert "enc_staged_bytes" not in trace.counters()
    _, events = _profiled(tmp_path,
                          lambda: enc.finish(enc.dispatch_frames(pcm)))
    spans = trace.spans()
    assert {s[1] for s in spans} == {1}
    _check(spans, events, ENCODE_SPANS)
    assert trace.counters()["enc_staged_bytes"] == {1: 4 * 2 * 1536 * 6 * 2}
