"""Checkpoint / resume of decode and encode state.

The decoder's carried state is the OLA delay planes + downmixed flag:
(delay [..., 6, 128] f32, downmixed [...] bool), per lane or for one
stream, plus, for the Python parser, its side-info caches
(host.parse.DecoderState).  The files are the JAX package's ``.npz``
layout in both directions: "delay" and "downmixed", and with a parser
its state as plain arrays and one JSON blob of scalars -- pure data, no
pickle, so loading an untrusted file cannot run code.

The encoder's carried state is (last [..., ch, 256] int32: the last
block's samples, csnroffst [...] int32), saved as "last" and "csnr".

A carry split over a mesh (parallel.mesh.Sharded) is gathered when it is
saved, as np.asarray gathers a sharded JAX array, and load_decode_state
can split one over a mesh again.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..parallel.mesh import check_mesh, stream_sharding
from .device import resolve_device


def carry_from_numpy(delay, downmixed, device=None):
    """numpy (delay, downmixed) -> carry tensors on `device` (None: the
    CUDA card)."""
    device = resolve_device(device)
    # np.array, not np.ascontiguousarray: a single stream's downmixed
    # flag is 0-d, and ascontiguousarray would make it [1]
    return (torch.from_numpy(np.array(delay, np.float32, order="C"))
            .to(device),
            torch.from_numpy(np.array(downmixed, bool, order="C"))
            .to(device))


def carry_to_numpy(carry):
    """carry tensors (on a device or Sharded over a mesh) -> numpy (delay
    f32, downmixed bool)."""
    delay, downmixed = carry
    return delay.cpu().numpy(), downmixed.cpu().numpy()


def _pack_parser_state(s) -> dict:
    """DecoderState -> flat dict of plain npz-safe arrays."""
    from ..host.parse import ChannelBA
    blobs = {}
    scalars = {}
    for name, val in vars(s).items():
        if name == "dynrng_call":
            continue            # runtime callback, not stream state
        if isinstance(val, ChannelBA):
            scalars[name] = [int(val.bai), int(val.deltbae)]
            blobs["pba_" + name] = np.asarray(val.deltba)
        elif isinstance(val, list):          # s.ba: list[ChannelBA]
            scalars[name] = [[int(b.bai), int(b.deltbae)] for b in val]
            for i, b in enumerate(val):
                blobs[f"pba_{name}{i}"] = np.asarray(b.deltba)
        elif isinstance(val, np.ndarray):
            blobs["parr_" + name] = val
        elif isinstance(val, (bool, np.bool_)):
            scalars[name] = ["b", int(val)]
        elif isinstance(val, (float, np.floating)):
            scalars[name] = ["f", float(val)]
        else:
            scalars[name] = ["i", int(val)]
    blobs["pscalars"] = np.frombuffer(
        json.dumps(scalars).encode(), np.uint8).copy()
    return blobs


def _unpack_parser_state(z):
    """The arrays of a checkpoint -> host.parse.DecoderState."""
    from ..host.parse import ChannelBA, DecoderState
    s = DecoderState()
    scalars = json.loads(z["pscalars"].tobytes().decode())
    for name, spec in scalars.items():
        cur = getattr(s, name)
        if isinstance(cur, ChannelBA):
            setattr(s, name, ChannelBA(bai=spec[0], deltbae=spec[1],
                                       deltba=z[f"pba_{name}"].copy()))
        elif isinstance(cur, list):
            setattr(s, name, [
                ChannelBA(bai=bi, deltbae=de,
                          deltba=z[f"pba_{name}{i}"].copy())
                for i, (bi, de) in enumerate(spec)])
        else:
            kind, v = spec
            if kind == "b":
                setattr(s, name, bool(v))
            elif kind == "f":
                setattr(s, name, np.float32(v))
            else:
                setattr(s, name, int(v))
    for key in z.files:
        if key.startswith("parr_"):
            setattr(s, key[len("parr_"):], z[key].copy())
    return s


def save_decode_state(path: str, carry, parser=None):
    """Write the carry (and, given a host.parse.A52Parser, its state) in
    the JAX package's .npz layout."""
    delay, downmixed = carry_to_numpy(carry)
    blobs = {"delay": delay, "downmixed": downmixed}
    if parser is not None:
        blobs.update(_pack_parser_state(parser.s))
    np.savez(path, **blobs)


def load_decode_state(path: str, device=None, mesh=None):
    """-> carry (delay, downmixed) on `device`, or split over the 'data'
    axis of `mesh` (parallel.mesh.make_mesh; device stays None)."""
    if check_mesh(mesh) is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        return stream_sharding(mesh).put(load_decode_state(path, "cpu"))
    with np.load(path, allow_pickle=False) as z:
        return carry_from_numpy(z["delay"], z["downmixed"], device)


def load_parser_state(path: str):
    """-> the host.parse.DecoderState saved beside the carry, or None when
    the file holds no parser state.  Give it to a parser as
    ``parser.s = load_parser_state(path)``."""
    with np.load(path, allow_pickle=False) as z:
        return _unpack_parser_state(z) if "pscalars" in z else None


def save_encode_state(path: str, last_samples, csnroffst):
    """Write an encoder carry (tensors or arrays) in the JAX package's
    .npz layout."""
    np.savez(path, last=np.asarray(torch.as_tensor(last_samples).cpu()),
             csnr=np.asarray(torch.as_tensor(csnroffst).cpu()))


def load_encode_state(path: str, device=None):
    """-> (last, csnroffst) int32 tensors on `device` (None: the CUDA
    card)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        return tuple(torch.from_numpy(np.array(z[k], np.int32)).to(device)
                     for k in ("last", "csnr"))
