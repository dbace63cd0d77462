"""The readers of the program's spans and counters (feed_ms ... lib_load_s),
on hand-made spans and counters: each returns its value, and None where
what it reads is absent, also from a program that has no spans at all."""
import importlib

import pytest

from ac3acm_tpu_torch.utils import trace
from benchmark.core.runner import Context

MS = 1_000_000                                       # ns
# three window steps; a reader takes the median of each step's sum
SPANS = [(name, step, 0, int(ms * MS)) for step, row in enumerate((
    dict(feed=1, sideinfo_parse=30, chunk_assembly=20, prune_plan=4, h2d=5,
         **{"unpack.exponents": 6, "unpack.alloc": 7, "unpack.mantissas": 8},
         tail=2, encode=9, **{"finish.wait": 11, "finish.bytes": 3}),
    dict(feed=3, sideinfo_parse=50, chunk_assembly=22, prune_plan=6, h2d=7,
         **{"unpack.exponents": 8, "unpack.alloc": 9, "unpack.mantissas": 10},
         tail=4, encode=11, **{"finish.wait": 13, "finish.bytes": 5}),
    dict(feed=2, sideinfo_parse=40, chunk_assembly=21, prune_plan=5, h2d=6,
         **{"unpack.exponents": 7, "unpack.alloc": 8, "unpack.mantissas": 9},
         tail=3, encode=10, **{"finish.wait": 12, "finish.bytes": 4}),
)) for name, ms in row.items()]
# feed spans are one a lane: split step 0's over two lanes
SPANS += [("feed", 0, 0, MS)]
COUNTERS = {"feed_copied_bytes": {0: 1_000_000, 1: 3_000_000, 2: 2_000_000},
            "lib_load_s": {None: 1.5}}

EXPECTED = dict(feed_ms=2.0, parse_ms=40.0, assembly_ms=26.0, h2d_ms=6.0,
                unpack_host_ms=24.0, enqueue_ms=13.0, finish_wait_ms=12.0,
                feed_copy_mb=2.0, lib_load_s=1.5)


def _reader(name):
    return importlib.import_module(f"benchmark.metrics.{name}").read


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(trace, "_spans", list(SPANS))
    monkeypatch.setattr(trace, "_counters",
                        {k: dict(v) for k, v in COUNTERS.items()})


@pytest.fixture
def empty(monkeypatch):
    monkeypatch.setattr(trace, "_spans", [])
    monkeypatch.setattr(trace, "_counters", {})


def _ctx():
    return Context(cell={}, lanes=None)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(name, recorded):
    assert _reader(name)(_ctx()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_without_spans(name, empty):
    assert _reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_on_a_program_without_spans(name, monkeypatch):
    """The parent of the change that added the spans has neither
    spans nor counters: the reader finds nothing and raises nothing."""
    monkeypatch.delattr(trace, "spans")
    monkeypatch.delattr(trace, "counters")
    assert _reader(name)(_ctx()) is None

