"""Device mesh: the lane split over 'data' and the 'model' axis.

The counterpart of the JAX package's parallel/mesh.py.  Its mesh is
single-controller: one process drives every device, and a function jitted
with ``in_shardings=NamedSharding(mesh, P("data"))`` splits axis 0 of
every operand over the mesh's 'data' axis.  The port keeps that form, so
that a JAX caller's code translates line for line: one process, a
[data, model] grid of ``torch.device``s (``make_mesh``), placement
helpers (``stream_sharding``, ``replicated``) and ``Sharded``, a tensor
whose lane axis is cut into ``data`` equal contiguous blocks, block i on
data row i's device.  ``over_data(mesh, fn)`` runs a one-device function
once per data row on that row's blocks, queueing every row before anything
waits, and returns its outputs sharded the same way.  A step between
devices is ``.to(device, non_blocking=True)``: a peer copy between
distinct cards.  ``torch.distributed`` (one process a rank and a process
group) is a different API, and the JAX package has no multi-process form
to port.

Under P("data") the 'model' axis replicates: in JAX every device of a data
row holds the row's block and computes it.  The port keeps one copy of a
row, on the row's model-0 device, and computes it once; only
parallel.pipeline.tp_filterbank splits work over 'model'.

A mesh may name a device more than once (the tests' ``["cpu"] * 8``, one
card's ``["cuda:0"] * 4``): its shards then run one after another on that
device, through every line of the split.  Every CUDA device of a mesh
carries its index: the port's per-device table caches key on the device,
and a table cached under a bare "cuda" would land on whichever card was
current at first use.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device


class Mesh:
    """A [data, model] grid of torch.devices (make_mesh builds one).

    .shape is {"data": d, "model": m}, .axis_names ("data", "model"),
    .devices the grid as a [d, m] numpy array of torch.device.  Two meshes
    of the same grid are equal and hash alike (a cache key)."""

    axis_names = ("data", "model")

    def __init__(self, grid):
        self.grid = tuple(tuple(row) for row in grid)

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    @property
    def devices(self) -> np.ndarray:
        out = np.empty((len(self.grid), len(self.grid[0])), object)
        for i, row in enumerate(self.grid):
            for j, dev in enumerate(row):
                out[i, j] = dev
        return out

    @property
    def row_devices(self) -> tuple:
        """Each data row's model-0 device: where its block lives."""
        return tuple(row[0] for row in self.grid)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.grid == other.grid

    def __hash__(self):
        return hash(self.grid)

    def __repr__(self):
        names = [[str(d) for d in row] for row in self.grid]
        return f"Mesh(data={len(self.grid)}, model={len(self.grid[0])}, " \
               f"devices={names})"


def _indexed(device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """2D ('data', 'model') mesh; data defaults to len(devices) // model.

    devices: None -> every visible CUDA card, as cuda:0, cuda:1, ... (raises
    without one); else a list of devices or names, row-major, which may
    repeat a device (["cpu"] * 8, ["cuda:0"] * 4)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices=[...] "
                "(for example ['cpu'] * 8) to build a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_indexed(d) for d in devices]
    n = len(devs)
    if data is None:
        data = n // model
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh([devs[i * model:(i + 1) * model] for i in range(data)])


def check_mesh(mesh):
    """mesh, if it is None or a Mesh; raises TypeError otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh) or "
                        f"None, not {type(mesh).__name__}")
    return mesh


class Sharded:
    """A tensor placed on a mesh: parts[i] on data row i's device, either
    axis 0 cut into equal contiguous blocks (split) or a whole copy
    (replicated).  np.asarray(x), x.cpu() and x.gather(device) give the
    whole tensor, as np.asarray does for a sharded JAX array."""

    __slots__ = ("parts", "mesh", "split")

    def __init__(self, parts, mesh: Mesh, split: bool = True):
        self.parts, self.mesh, self.split = list(parts), mesh, split

    @property
    def shape(self) -> torch.Size:
        head = self.parts[0].shape
        if not self.split:
            return head
        return torch.Size((sum(p.shape[0] for p in self.parts),)
                          + tuple(head[1:]))

    @property
    def dtype(self):
        return self.parts[0].dtype

    def gather(self, device="cpu") -> torch.Tensor:
        """The whole tensor on one device (default: the host)."""
        if not self.split:
            return self.parts[0].to(device)
        return torch.cat([p.to(device) for p in self.parts])

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self):
        kind = "split" if self.split else "replicated"
        return f"Sharded({kind}, shape={tuple(self.shape)}, " \
               f"dtype={self.dtype}, {self.mesh!r})"


def tree_map(fn, tree):
    """fn over the tensor, array and Sharded leaves of nested tuples,
    lists and dicts; other leaves (None, numbers) are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray, Sharded)):
        return fn(tree)
    return tree


@dataclass(frozen=True)
class Placement:
    """Lays out pytrees of tensors on a mesh: axis 0 split over 'data'
    (stream_sharding, P("data")) or a whole copy on each data row
    (replicated, P())."""

    mesh: Mesh
    split: bool

    def _put(self, x):
        if isinstance(x, Sharded):
            if x.mesh == self.mesh and x.split == self.split:
                return x                          # already placed: no move
            x = x.gather(x.parts[0].device)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        rows = self.mesh.row_devices
        if not self.split:
            return Sharded([x.to(d, non_blocking=True) for d in rows],
                           self.mesh, split=False)
        n = x.shape[0] if x.dim() else 0
        if n == 0 or n % len(rows):
            raise ValueError(
                f"a lane axis of {n} does not divide over data="
                f"{len(rows)} (shape {tuple(x.shape)})")
        step = n // len(rows)
        return Sharded([x[i * step:(i + 1) * step].to(d, non_blocking=True)
                        for i, d in enumerate(rows)], self.mesh)

    def put(self, tree):
        """Every tensor or array of tree placed on the mesh (a Sharded
        already placed so stays where it is)."""
        return tree_map(self._put, tree)

    def gather(self, tree, device="cpu"):
        """Every Sharded of tree as one tensor on `device`."""
        return tree_map(lambda x: x.gather(device)
                        if isinstance(x, Sharded) else x, tree)


def stream_sharding(mesh: Mesh) -> Placement:
    """Leading stream-batch axis split over 'data'."""
    return Placement(mesh, True)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, False)


def _zip_rows(outs: list, mesh: Mesh):
    """Per-row output trees of one structure -> one tree of Sharded."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _zip_rows([o[k] for o in outs], mesh) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_zip_rows([o[i] for o in outs], mesh)
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return Sharded(outs, mesh)
    return first


def over_data(mesh: Mesh, fn):
    """fn over the data rows of mesh -> g(*args): every tensor or array of
    args split over 'data' (stream_sharding(mesh).put; a Sharded already
    there is not moved), fn called once per row on that row's blocks, on
    that row's device, and the tensors fn returns gathered into Sharded
    outputs.  Every row is queued before anything waits, as long as fn
    itself does not wait on its device."""
    place = stream_sharding(mesh)

    def g(*args):
        args = place.put(args)
        outs = [fn(*tree_map(lambda s, i=i: s.parts[i], args))
                for i in range(mesh.shape["data"])]
        return _zip_rows(outs, mesh)

    return g
