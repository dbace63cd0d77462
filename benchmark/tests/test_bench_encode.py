"""The encode cell on the CPU at a toy size (16 lanes, one chunk of
window): a sound run is correct; each fault planted in the timed path is
not (the encoder's carry kept across a dispatch, half the lanes' bytes
zeroed, one byte altered, the PCM handed over in liba52's LFE-first
order); the frozen PCM is the reference decode the configuration
describes; the cell loads with its readers, and the readers of its spans,
counter and kernels read what they should, and None where nothing is
there (a program without the spans)."""
import importlib
import os

import numpy as np
import pytest

from ac3acm_tpu_torch.utils import trace
from benchmark.core import bounds
from benchmark.core.content import make_lanes
from benchmark.core.runner import Context, run_cell
from benchmark.core.spec import BENCH, load_cell
from benchmark.paths import encode as PE
from benchmark.tests.test_bench_run import _answer_altered, _half_left_out

CELL = "enc51-640-2048x8"
SEED = 2**31 + 17


def _run(hook=None):
    cell = load_cell(CELL)
    cell["traffic"] = dict(cell["traffic"], lanes=16, warm_chunks=2)
    return run_cell(cell, SEED, 0.0, False, "cpu", hook=hook)[:2]


def _carry_kept(path):
    enc = path._enc
    disp = enc.dispatch_frames

    def dispatch(pcm):
        saved = (enc.last, enc.csnr)
        h = disp(pcm)
        enc.last, enc.csnr = saved
        return h
    enc.dispatch_frames = dispatch


def _lfe_first(path):
    first = np.argsort(PE.LFE_LAST)          # the encoder's order -> liba52's
    path._pcm = [np.ascontiguousarray(x[..., first]) for x in path._pcm]


def test_sound_run_is_correct():
    result, numbers = _run()
    assert result["correct"], numbers
    assert all(v == 0 for v, _ in numbers.values())
    assert result["attempted"] == 16 * 8 and result["failed"] == 0


@pytest.mark.parametrize("fault", [_carry_kept, _half_left_out,
                                   _answer_altered, _lfe_first],
                         ids=["carry_kept", "half_left_out",
                              "answer_altered", "lfe_first"])
def test_fault_is_not_correct(fault):
    result, numbers = _run(fault)
    assert not result["correct"], numbers


def test_frozen_pcm_is_the_reference_decode():
    cell = load_cell(CELL)
    config, dec = cell["config"], cell["config"]["decode"]
    lanes = make_lanes(cell["traffic"], 0)
    fresh = PE.content_pcm(lanes.streams, int(dec["flags"]),
                           float(dec["level"]), float(dec["bias"]))
    np.testing.assert_array_equal(PE.load_pcm(config, lanes), fresh)


SPAN_READERS = dict(enc_stage_ms="enc.stage", enc_h2d_ms="enc.h2d",
                    enc_run_ms="enc.run", enc_wait_ms="enc.wait",
                    enc_bytes_ms="enc.bytes")
ROOFLINES = dict(m1_roofline="window_mdct_kernel",
                 x1_roofline="exponents_kernel",
                 e1_roofline="snr_search_kernel",
                 q1_roofline="quantize_kernel",
                 p1_51_roofline="pack_frames_kernel")


def _reader(name):
    return importlib.import_module(f"benchmark.metrics.{name}").read


def test_cell_loads_with_its_readers():
    c = load_cell(CELL)
    assert c["config"]["entry"] == "encode" and c["chips"] == 1
    assert c["traffic"]["lanes"] % (2 * 8) == 0
    for name in c["traffic"]["content"]:
        assert os.path.exists(os.path.join(BENCH, "data", name))
    assert [m["name"] for m in c["end_to_end"]] == ["xrt", "setup_s"]
    assert [m["name"] for m in c["per_layer"]] == (
        list(SPAN_READERS) + ["enc_staged_mb"] + list(ROOFLINES))
    for m in c["per_layer"]:
        assert callable(_reader(m["name"]))


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader(name, monkeypatch):
    """Two spans in step 0 (1 + 2 ms), one in each of steps 1 and 2 (5 and
    4 ms): the median of the steps' sums, 4 ms; a span of another name is
    not read."""
    span = SPAN_READERS[name]
    ms = 1_000_000
    monkeypatch.setattr(trace, "_spans", [
        (span, 0, 0, ms), (span, 0, ms, 3 * ms), (span, 1, 0, 5 * ms),
        (span, 2, 0, 4 * ms), ("encode", 1, 0, 99 * ms)])
    assert _reader(name)(Context(cell={}, lanes=None)) == pytest.approx(4.0)
    monkeypatch.setattr(trace, "_spans", [])
    assert _reader(name)(Context(cell={}, lanes=None)) is None


def test_staged_counter_reader(monkeypatch):
    monkeypatch.setattr(trace, "_counters", {"enc_staged_bytes": {
        0: 301_989_888, 1: 301_989_888, 2: 0}})
    read = _reader("enc_staged_mb")
    assert read(Context(cell={}, lanes=None)) == pytest.approx(301.989888)
    monkeypatch.setattr(trace, "_counters", {})
    assert read(Context(cell={}, lanes=None)) is None


@pytest.mark.parametrize("name", sorted(SPAN_READERS) + ["enc_staged_mb"])
def test_reader_none_on_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(trace, "spans")
    monkeypatch.delattr(trace, "counters")
    assert _reader(name)(Context(cell={}, lanes=None)) is None


@pytest.fixture(scope="module")
def small_ref():
    """The checked chunk's reference at 16 lanes, as a traced run has it."""
    cell = load_cell(CELL)
    lanes = make_lanes(dict(cell["traffic"], lanes=16), 5)
    return cell, lanes, PE.reference(lanes, cell["config"], 3)


@pytest.mark.parametrize("name", sorted(ROOFLINES))
def test_roofline_reader(name, small_ref):
    """Each kernel's least time from core.bounds on the chunks traced (3
    here, one launch each), over the profiler's seconds for the kernel
    alone (another kernel's time is not read); None without a trace, the
    kernel or the reference's classes."""
    cell, lanes, ref = small_ref
    cfg, rows, w = ref["cfg"], 16 * 8, 16 / 16
    least = dict(
        m1_roofline=3 * bounds.m1_ms(rows, 6),
        x1_roofline=3 * bounds.x1_ms(rows, 6),
        e1_roofline=bounds.e1_ms(3 * rows, cfg.nb_coefs, 3),
        q1_roofline=3 * w * bounds.q1_ms(ref["bap"]),
        p1_51_roofline=3 * w * bounds.p1_ms(cfg.nb_coefs, cfg.frame_size,
                                            ref["bap"], ref["strat"]))[name]
    kernels = {f"void {k}<6>(int*)": [3, 0.002] for k in ROOFLINES.values()}
    kernels["void other_kernel(int*)"] = [3, 1.0]
    ctx = Context(cell=cell, lanes=lanes, trace=dict(kernels=kernels),
                  chunks_traced=3, ref=ref)
    assert cfg.channels == 6 and cfg.nb_coefs == (223,) * 5 + (7,)
    assert _reader(name)(ctx) == pytest.approx(100 * least / 2.0)
    kernels.pop(next(k for k in kernels if ROOFLINES[name] in k))
    assert _reader(name)(ctx) is None
    assert _reader(name)(Context(cell=cell, lanes=lanes, ref=ref)) is None
    assert _reader(name)(Context(cell=cell, lanes=lanes,
                                 trace=dict(kernels=kernels))) is None
