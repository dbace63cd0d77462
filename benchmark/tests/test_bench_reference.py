"""The plain reference: liba52's float output bit for bit on the content
streams, its batched form equal to its one-lane form, its dither LFSR
jump equal to decoding a lane from its first frame, and its transcode
equal to the program's on the CPU."""
import os

import numpy as np
import pytest
import torch

from benchmark.core.check import frame_stats
from benchmark.paths import transcode as TC
from benchmark.core.content import Lanes, lfsr_states, make_lanes
from benchmark.core.spec import BENCH, load_cell
from benchmark.reference.decode import decode_lanes, split_frames
from benchmark.reference.encode import encode_lanes, make_config
from benchmark.reference.imdct import convert_to_int16

STREAMS = ("bench_51_448.ac3", "realaudio_51_448.ac3")
FLAGS = 2 | 32                                # A52_STEREO | A52_ADJUST_LEVEL


def _frames(name):
    with open(os.path.join(BENCH, "data", name), "rb") as f:
        return split_frames(f.read())


@pytest.mark.parametrize("name", STREAMS)
def test_reference_decode_is_liba52_bit_for_bit(name, golden):
    """Float PCM at bias 0 over the stream's 48 blocks against the compiled
    float liba52's (tests/golden/*.stereo_float.npy): max |diff| 0."""
    pcm = decode_lanes([_frames(name)], FLAGS, 1.0, 0.0, [1])[0]
    oracle = np.load(os.path.join(golden, name + ".stereo_float.npy"))
    assert pcm.shape == (8, 6, 2, 256)
    assert np.array_equal(pcm.numpy().reshape(48, 512), oracle)


def test_frame_stats_count_fields_and_dither_draws():
    lanes = Lanes(streams=[_frames(n) for n in STREAMS],
                  stream=np.array([0]), start=np.array([0]),
                  frames_per_chunk=8)
    draws, fields, sizes = frame_stats(lanes, FLAGS, 1.0, 384.0)
    assert (draws > 2000).all() and (fields > 2000).all()
    assert (sizes == 1792).all()


def test_frozen_data_is_the_golden_streams(golden):
    for name in STREAMS:
        with open(os.path.join(golden, name), "rb") as f:
            assert f.read() == open(os.path.join(BENCH, "data", name),
                                    "rb").read()


def test_batched_reference_equals_one_lane_at_a_time():
    seqs = [_frames(STREAMS[0]), _frames(STREAMS[1])[3:] + _frames(STREAMS[1])[:3]]
    both = decode_lanes(seqs, FLAGS, 1.0, 384.0, [1, 4321])
    for i, st in enumerate((1, 4321)):
        assert torch.equal(both[i], decode_lanes([seqs[i]], FLAGS, 1.0,
                                                 384.0, [st])[0])


def test_lfsr_jump_matches_a_lane_decoded_from_its_first_frame():
    """A lane's frames 17..19 decoded from its first frame (LFSR state 1,
    the delay carried through) equal the reference's jump start: the LFSR
    stepped by the draws of the frames before, one frame of delay."""
    lanes = Lanes(streams=[_frames(n) for n in STREAMS],
                  stream=np.array([0, 1]), start=np.array([5, 2]),
                  frames_per_chunk=3)
    draws, _, _ = frame_stats(lanes, FLAGS, 1.0, 384.0)
    t0 = 17
    states = lfsr_states(lanes, draws, t0 - 1)
    for s, f0 in ((0, 5), (1, 2)):
        full = decode_lanes([lanes.frames(s, f0, 0, t0 + 3)], FLAGS, 1.0,
                            384.0, [1])[0]
        jump = decode_lanes([lanes.frames(s, f0, t0 - 1, 4)], FLAGS, 1.0,
                            384.0, [states[lanes.combos().index((s, f0))]])
        assert torch.equal(full[t0:], jump[0, 1:])


def test_lanes_split_evenly_whatever_the_seed():
    cell = load_cell("dec51-raw-4096x16")
    for seed in (0, 2**31 + 7, 2**40 + 3):
        lanes = make_lanes(cell["traffic"], seed)
        counts = np.bincount(lanes.combo_of_lane(), minlength=16)
        assert (counts == 4096 // 16).all()
    a = make_lanes(cell["traffic"], 5).combo_of_lane()
    b = make_lanes(cell["traffic"], 5).combo_of_lane()
    c = make_lanes(cell["traffic"], 6).combo_of_lane()
    assert (a == b).all() and (a != c).any()


def test_chunk_bytes_follow_each_lane_cyclically():
    lanes = Lanes(streams=[_frames(n) for n in STREAMS],
                  stream=np.array([0, 1, 1]), start=np.array([0, 3, 7]),
                  frames_per_chunk=3)
    chunk = lanes.chunk_bytes()
    for k in range(4):
        got = chunk(k)
        for i in range(3):
            want = b"".join(lanes.frames(int(lanes.stream[i]),
                                         int(lanes.start[i]), 3 * k, 3))
            assert got[i] == want


def test_reference_transcode_equals_the_program_on_the_cpu():
    """Two lanes through the program's Transcoder(parser="raw") on the CPU
    (its plain versions) against the reference chunk: the same bytes."""
    from ac3acm_tpu_torch.parallel.transcode import Transcoder
    cell = load_cell("tc51-raw-4096x8")
    lanes = Lanes(streams=[_frames(n) for n in STREAMS],
                  stream=np.array([0, 1]), start=np.array([3, 6]),
                  frames_per_chunk=8)
    tc = Transcoder(2, 192000, 2, pack="device", parser="raw", device="cpu")
    chunk = lanes.chunk_bytes()
    outs = [tc.step_frames(chunk(k), 8) for k in range(2)]
    ref = TC.reference(lanes, cell["config"], 1)
    combos = lanes.combos()
    for i in range(2):
        c = combos.index((int(lanes.stream[i]), int(lanes.start[i])))
        assert outs[1][i] == ref["frames"][c].tobytes()
    assert ref["enc_ok"].all()


def test_reference_encoder_frames_are_whole_and_synced():
    pcm = decode_lanes([_frames(STREAMS[0])[:3]], FLAGS, 1.0, 384.0, [1])[0]
    i16 = convert_to_int16(pcm)
    samples = i16.permute(0, 1, 3, 2).reshape(1, 3, 1536, 2)
    cfg = make_config(48000, 192000, 2)
    frames, ok, fields = encode_lanes(cfg, samples,
                                      torch.zeros((1, 2, 256),
                                                  dtype=torch.int32))
    assert ok.all() and fields["bap"].shape == (1, 3, 6, 2, 256)
    for fr in frames[0]:
        assert len(fr) == 768 and fr[:2] == b"\x0b\x77"
