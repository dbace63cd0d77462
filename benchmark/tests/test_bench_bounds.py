"""The least-work counters on shapes counted by hand."""
import numpy as np
import pytest

from benchmark.core import bounds as B


def test_least_ms_takes_the_longer_of_bytes_and_operations():
    assert B.least_ms(3.35e9) == pytest.approx(1.0)
    assert B.least_ms(0, B.PEAK_ISSUE * 2e-3) == pytest.approx(2.0)
    assert B.least_ms(3.35e9, B.PEAK_ISSUE * 1e-3) == pytest.approx(1.0)


def test_b1f_bytes_of_one_lane_frame():
    # 1 lane x 1 frame x 2 planes: 12 rows of 256 f32 in and int16 out,
    # 2 chains' carry in and out, 6 biases
    nbytes = 12 * 256 * 6 + 2 * 128 * 4 * 2 + 6 * 4
    assert B.b1f_ms(1, 1, 2) == pytest.approx(nbytes / B.PEAK_BYTES * 1e3)
    flop = 12 * (B.B1_LONG_ROW_FLOP + 9 * 256)
    assert flop / B.PEAK_FP32 < nbytes / B.PEAK_BYTES


def test_gather_bytes():
    assert B.gather_ms(1000, 10, 0) == pytest.approx(
        (1000 + 10 * 5) / B.PEAK_BYTES * 1e3)
    assert B.gather_ms(1000, 10, 3) == pytest.approx(
        (1000 + 50 + 65535 * 2 + 3 * 4) / B.PEAK_BYTES * 1e3)


def test_m1_x1_e1():
    # one lane-frame of one channel: 6 transforms
    assert B.m1_ms(1, 1) == pytest.approx(max(
        6 * 2049 / B.PEAK_BYTES, 6 * B.M1_TRANSFORM_OPS / B.PEAK_ISSUE) * 1e3)
    assert B.x1_ms(1, 1) == pytest.approx(max(
        6 * 1280 / B.PEAK_BYTES, 6 * 256 * 12 / B.PEAK_ISSUE) * 1e3)
    # two channels of 223 live bins: 2 x 6 x 223 exponents in, classes out
    assert B.e1_ms(1, (223, 223)) == pytest.approx(
        (2 * 6 * 446 + 12 + 2 * 5 + 200) / B.PEAK_BYTES * 1e3)


def test_q1_counts_classes_and_coded_bins():
    bap = np.zeros((2, 256), np.int8)
    bap[0, :3] = (1, 0, 15)               # two coded bins in row 0
    nbytes = 3 * 512 + 5 * 2 + 4 * 1
    assert B.q1_ms(bap) == pytest.approx(max(
        nbytes / B.PEAK_BYTES, 2 * 16 / B.PEAK_ISSUE) * 1e3)


def test_p1_counts_the_frame_and_the_coded_exponents():
    nb, fs = (223, 223), 384
    bap = np.zeros((1, 6, 2, 256), np.int8)
    bap[0, 0, 0, :10] = 3
    bap[0, 0, 0, 250] = 3                 # past the live bins: not counted
    strat = np.zeros((1, 6, 2), np.int32)
    strat[0, 0] = (1, 3)                  # D15 on ch 0, D45 on ch 1
    ng15, ng45 = (223 + 3 - 4) // 3, (223 + 12 - 4) // 12
    exps = (1 + 3 * ng15) + (1 + 3 * ng45)
    nbytes = 6 * 446 + 6 * 2 * 4 + 8 + 768 + 2 * 10 + exps
    ops = 6 * 446 * B.P1_BIN_OPS + 768 * B.P1_CRC_OPS
    assert B.p1_ms(nb, fs, bap, strat) == pytest.approx(max(
        nbytes / B.PEAK_BYTES, ops / B.PEAK_ISSUE) * 1e3)
