"""Whole runs on the CPU at a toy size (16 lanes, one chunk of window),
with the harness's look for a card skipped: a sound run is correct; the
control (the program's fast accuracy mode, within 1 LSB of the reference)
and each fault a cell can have, planted in the timed path, are not.  And
the command itself fails without a card, or without the program beside
it, printing no result."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark.core.runner import run_cell
from benchmark.core.spec import BENCH, ROOT, load_cell

CELLS = ("dec51-raw-4096x16", "tc51-raw-4096x8")
SEED = 2**31 + 17


def _small(name):
    cell = load_cell(name)
    cell["traffic"] = dict(cell["traffic"], lanes=16, frames_per_chunk=8,
                           warm_chunks=2)
    return cell


def _run(name, **kw):
    result, numbers, _ = run_cell(_small(name), SEED, 0.0, False, "cpu", **kw)
    return result, numbers


def _state_unchanged(path):
    """Every step leaves the decoder's (and the encoder's) state as it
    found it."""
    bd = path.decoder()
    orig = bd.decode_available

    def call(max_frames=8, clock=None):
        saved = (bd._carry, getattr(bd, "_raw_carry", None))
        r = orig(max_frames, clock=clock)
        bd._carry = saved[0]
        if saved[1] is not None:
            bd._raw_carry = saved[1]
        return r
    bd.decode_available = call
    tc = getattr(path, "_tc", None)
    if tc is not None:
        disp = tc.dispatch_frames

        def dispatch(data, nframes):
            saved = (tc.enc_last, tc.enc_csnr)
            h = disp(data, nframes)
            tc.enc_last, tc.enc_csnr = saved
            return h
        tc.dispatch_frames = dispatch


def _wrap_output(path, edit):
    finish = path.finish

    def call(handle):
        out, valid = finish(handle)
        return edit(out), valid
    path.finish = call


def _half_left_out(path):
    def edit(out):
        if isinstance(out, list):
            h = len(out) // 2
            return out[:h] + [bytes(len(b)) for b in out[h:]]
        out = np.array(out)
        out[len(out) // 2:] = 0
        return out
    _wrap_output(path, edit)


def _answer_altered(path):
    def edit(out):
        if isinstance(out, list):
            b = bytearray(out[0])
            b[100] ^= 0x10
            return [bytes(b)] + out[1:]
        out = np.array(out)
        out[0, 0, 0, 0] ^= 1
        return out
    _wrap_output(path, edit)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, numbers = _run(cell)
    assert result["correct"], numbers
    assert all(v == 0 for v, _ in numbers.values())
    assert result["attempted"] == 16 * 8 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fast_mode_is_not_correct(cell):
    result, numbers = _run(cell, accuracy="fast")
    assert not result["correct"], numbers


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    result, numbers = _run(cell, hook=fault)
    assert not result["correct"], numbers


def _command(cwd, env=None):
    env = dict(os.environ if env is None else env)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(r):
    lines = r.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        json.loads(lines[-1])
    except ValueError:
        return True
    return False


def test_command_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _command(ROOT)
    assert r.returncode == 3 and _no_result(r), r.stderr
    assert "no CUDA device" in r.stderr


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = _command(str(tmp_path))
    assert r.returncode != 0 and _no_result(r), r.stderr
