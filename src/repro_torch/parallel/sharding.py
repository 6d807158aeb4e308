"""Data-parallel sharding of the batched passes over a mesh of devices.

Counterpart of the data-parallel half of ``repro.parallel.sharding``
(``data_parallel_map``, ``axis_size``, ``pad_batch``, ``use_mesh``,
``active_mesh``).  JAX's ``shard_map`` splits a batch over a mesh axis
from one controller; PyTorch has no single-controller mesh, and
``torch.distributed``'s ``DeviceMesh`` needs a process for each card.  So
the port keeps a small :class:`Mesh` of its own: an array of
``torch.device``s with named axes, all driven by one host thread.

* A slot may repeat a device, the counterpart of the reference tests'
  ``--xla_force_host_platform_device_count``: the CPU tests run N slots
  of ``'cpu'``, and a mesh of four slots of one card runs four shards on
  it at once.
* Each CUDA slot has a stream of its own, made at its first use, also
  where the device repeats, so the shards of one call overlap.

:func:`data_parallel_map` splits a padded leading axis into equal
contiguous shards, one a slot along the axis, queues each shard's
launches on its slot's device and stream, and gathers the outputs on the
mesh's first device, all without a host sync:

* each slot stream waits on an event recorded on the first device's
  current stream, so a shard is read only after whatever produced it;
* a shard for another card is a peer copy (``non_blocking``).  PyTorch
  queues a copy between cards on the current streams of both, so each
  such slot also has a link stream on the first device, current there
  while its work is queued: its copies in and out wait on that slot's
  streams alone, never on the first device's stream, which has already
  been told to wait for the slots queued before it;
* a shard on the first device is a view whose storage is recorded on the
  slot's stream, so the caching allocator does not hand it out again while
  the slot still reads it;
* the first device's stream waits on an event recorded behind each slot's
  launches and its copy back, and each output is recorded on that stream
  before the gather (``torch.cat``).

Given the count of real rows, the slots whose shards hold only padding
are not launched, so a chunk of fewer rows than slots runs on as many
slots as it fills.

With more than one axis, the shards go to the devices along ``axis`` at
index 0 of the other axes: ``shard_map`` runs the same shard on every
device of the other axes, which gives the same output.

The logical-axis half (``Ax``, ``DEFAULT_RULES``, the rules of
:func:`use_mesh`, :func:`active_rules`, :func:`pspec`, :func:`constrain`)
serves the LLM scaffold (``repro_torch.models``).  :func:`pspec` gives the
reference's ``PartitionSpec`` as a plain tuple, one entry a dimension
(``None``, a mesh-axis name or a tuple of them).  The port runs a model on
one device: :func:`constrain` is a no-op without a mesh or on a mesh of
one slot, and raises on a mesh of more, since model parallelism over
several cards is not ported (ROADMAP.md, Queue 1 item 5.3).  The
reference's ``named_sharding``, ``param_shardings`` and
``tree_shardings`` serve only its trainer and dry-run (item 5.2), and
``shard_map_compat`` only its pipeline parallelism (item 5.3).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import numpy as np
import torch

from repro_torch.core.dispatcher import resolve_device


def slot_device(device) -> torch.device:
    """``device`` resolved as a mesh slot: a CUDA device carries its index
    (the current device's where none is given)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A single-controller mesh: an array of ``torch.device``s whose axes
    carry names.

    ``devices`` is an array-like of devices (``torch.device``s or their
    names) with one dimension for each name in ``axis_names``; a device may
    repeat.  Each slot resolves through ``core/dispatcher.resolve_device``
    (a CUDA slot without a card raises), and all slots are of one type.
    ``shape`` maps each axis to its size, in order; ``devices`` is the
    object array of the slots' ``torch.device``s; ``home`` the first of
    them, where :func:`data_parallel_map` gathers.  ``received`` is a
    diagnostic, read by no part of the extraction: for each slot, the bytes
    of the shards it was given.
    """

    def __init__(self, devices, axis_names=("data",)):
        self.axis_names = tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(self.axis_names) or len(set(self.axis_names)) != arr.ndim:
            raise ValueError(f"a mesh needs one distinct axis name a dimension: devices of "
                             f"shape {arr.shape}, axis names {self.axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [slot_device(d) for d in arr.ravel()]
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"a mesh's slots are of one device type, got {list(flat)}")
        self.devices = flat.reshape(arr.shape)
        self.received = np.zeros(arr.shape, np.int64)
        self._streams: dict = {}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        return self.devices.flat[0]

    def slots(self, axis: str = "data") -> list:
        """Index tuples of the slots along ``axis``, at index 0 of the
        other axes."""
        a = self.axis_names.index(axis)
        return [tuple(k if i == a else 0 for i in range(self.devices.ndim))
                for k in range(self.devices.shape[a])]

    def stream(self, index) -> torch.cuda.Stream:
        """The CUDA stream of the slot at ``index``, made at its first use."""
        return self._stream(index, self.devices[index])

    def link(self, index) -> torch.cuda.Stream:
        """The first device's stream for the peer copies of the slot at
        ``index`` (the slot's own stream where it is on that device)."""
        if self.devices[index] == self.home:
            return self.stream(index)
        return self._stream(("link", index), self.home)

    def _stream(self, key, device) -> torch.cuda.Stream:
        s = self._streams.get(key)
        if s is None:
            s = self._streams[key] = torch.cuda.Stream(device=device)
        return s

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


@dataclasses.dataclass(frozen=True)
class Ax:
    """Logical-axes annotation used as a *leaf* inside nested dicts (e.g. the
    per-leaf axis names of a decode cache)."""

    axes: tuple


# the reference's FSDP + TP (+ DP over pods) rule set: logical axis -> mesh axes
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",  # FSDP on weight embed dims
    "embed_act": None,  # activation embed dim stays replicated
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "data",
    "layers": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
}


class _Ctx(threading.local):
    mesh: Mesh | None = None
    rules: dict | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None, rules: dict | None = None):
    """Make ``mesh`` the ambient mesh of this thread (:func:`active_mesh`),
    with ``rules`` over :data:`DEFAULT_RULES` as its logical-axis rule set
    (:func:`active_rules`)."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules = old


def active_mesh() -> Mesh | None:
    return _CTX.mesh


def active_rules() -> dict:
    return _CTX.rules or DEFAULT_RULES


def _mesh_axes_for(logical: str, rules: dict, mesh):
    ax = rules.get(logical, None)
    if ax is None:
        return None
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    if mesh is not None:
        axes = tuple(a for a in axes if a in mesh.shape)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def pspec(axes: tuple, rules: dict | None = None, mesh=None,
          shape: tuple | None = None) -> tuple:
    """The mesh axes of each dimension of a tuple of logical axis names:
    the reference's ``PartitionSpec`` as a tuple.

    ``mesh`` is anything with a ``shape`` mapping of axis names to sizes
    (a :class:`Mesh`); it defaults to the ambient one, ``rules`` to
    :func:`active_rules`.  No mesh axis is used twice (later dims lose the
    conflict and stay replicated).  When ``shape`` is given, mesh axes that
    do not divide the dim are dropped greedily (e.g. 56 attention heads on a
    16-way 'model' axis stay replicated).
    """
    rules = rules or active_rules()
    mesh = mesh or active_mesh()
    used: set = set()
    parts = []
    for i, name in enumerate(axes):
        m = None if name is None else _mesh_axes_for(name, rules, mesh)
        if m is None:
            parts.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(a for a in ms if a not in used)
        if shape is not None and mesh is not None:
            dim = shape[i]
            kept = []
            prod = 1
            for a in ms:  # greedy prefix that divides the dim
                if dim % (prod * mesh.shape[a]) == 0:
                    kept.append(a)
                    prod *= mesh.shape[a]
                else:
                    break
            ms = tuple(kept)
        if not ms:
            parts.append(None)
            continue
        used.update(ms)
        parts.append(ms if len(ms) > 1 else ms[0])
    return tuple(parts)


def constrain(x, *axes):
    """Sharding constraint by logical axes: ``x`` itself without an active
    mesh or on a mesh of one slot.  On a mesh of more slots it raises
    ``NotImplementedError``: a model runs on one device until model
    parallelism is ported (ROADMAP.md, Queue 1 item 5.3)."""
    mesh = active_mesh()
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return x
    raise NotImplementedError(
        f"constrain{pspec(tuple(axes), mesh=mesh, shape=tuple(x.shape))} on a mesh of "
        f"{mesh.shape}: model parallelism over several slots is not ported "
        f"(ROADMAP.md, Queue 1 item 5.3); run the model without a multi-slot mesh")


def axis_size(mesh: Mesh | None, axis: str = "data") -> int:
    """Size of ``axis`` on ``mesh`` (1 without a mesh or the axis)."""
    if mesh is None or axis not in mesh.shape:
        return 1
    return mesh.shape[axis]


def pad_batch(arrays, n: int, mesh: Mesh | None = None, axis: str = "data") -> tuple:
    """Pad leading axes of ``n`` rows to a multiple of the axis size with
    copies of row 0, which no caller reads back; a no-op without a mesh.
    Takes tensors (padded on their device) and numpy arrays."""
    n_data = axis_size(mesh, axis)
    total = -(-max(n, 1) // n_data) * n_data
    if total == n:
        return tuple(arrays)
    return tuple(_pad_rows(a, total - n) for a in arrays)


def _pad_rows(a, k: int):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:1].expand(k, *a.shape[1:])])
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[:1], k, axis=0)])


def data_parallel_map(fn, mesh: Mesh | None = None, axis: str = "data"):
    """Shard a batched device function over ``axis`` of a mesh.

    ``fn`` maps arrays with a leading batch axis (tensors, on its slot's
    device, or host numpy arrays) to a tensor or a tuple of tensors with
    the same leading axis, and launches on the current stream.  The
    returned function splits each argument's leading axis into equal
    contiguous shards, runs ``fn`` on each slot's shard (see the module
    docstring) and concatenates the outputs on the mesh's first device.
    Every argument's leading axis must be a multiple of the axis size
    (:func:`pad_batch`).  Given ``rows=``, the count of real rows before the
    padding, it launches only the slots whose shards hold one, and the
    output stops after the last of them.  ``mesh`` defaults to the ambient
    :func:`use_mesh` mesh; with no mesh, or no ``axis`` in it, ``fn`` is
    returned as it is.  An exception of any slot propagates.
    """
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or axis not in mesh.shape:
        return fn
    slots = mesh.slots(axis)

    def mapped(*arrays, rows: int | None = None):
        n = len(arrays[0])
        if n % len(slots) or any(len(a) != n for a in arrays):
            raise ValueError(f"data_parallel_map needs leading axes of one length, a "
                             f"multiple of the {len(slots)} slots of {axis!r} (pad_batch); "
                             f"got {[len(a) for a in arrays]}")
        step = n // len(slots)
        used = slots if rows is None or step == 0 else slots[:max(1, -(-rows // step))]
        run = _map_cuda if mesh.home.type == "cuda" else _map_host
        return run(fn, mesh, used, arrays, step)

    return mapped


def _map_host(fn, mesh, slots, arrays, step):
    parts = []
    for k, index in enumerate(slots):
        shard = [a[k * step:(k + 1) * step] for a in arrays]
        mesh.received[index] += sum(a.nbytes for a in shard)
        parts.append(fn(*shard))
    return _gather(parts)


def _to_slot(x, dev: torch.device, stream, link):
    """One shard on its slot: a view on the same card (recorded on the
    slot's stream), a peer copy to another (queued on ``link``, the first
    device's stream of this slot, which reads the source); host data stays
    as it is."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        return x
    if x.device == dev:
        x.record_stream(stream)
        return x
    x.record_stream(link)
    return x.to(dev, non_blocking=True)


def _map_cuda(fn, mesh, slots, arrays, step):
    home = mesh.home
    home_stream = torch.cuda.current_stream(home)
    ready = torch.cuda.Event()
    ready.record(home_stream)
    parts = []
    for k, index in enumerate(slots):
        dev, stream, link = mesh.devices[index], mesh.stream(index), mesh.link(index)
        # link is current on the first device, stream on the slot's: a copy
        # between them waits on this slot's streams and no others
        with torch.cuda.stream(link), torch.cuda.stream(stream):
            link.wait_event(ready)
            stream.wait_event(ready)
            shard = [_to_slot(a[k * step:(k + 1) * step], dev, stream, link) for a in arrays]
            mesh.received[index] += sum(a.nbytes for a in shard)
            out = fn(*shard)
            outs = out if isinstance(out, tuple) else (out,)
            if dev != home:
                outs = tuple(o.to(home, non_blocking=True) for o in outs)
            done = torch.cuda.Event()
            done.record(link)
        home_stream.wait_event(done)
        for o in outs:
            o.record_stream(home_stream)
        parts.append(outs if isinstance(out, tuple) else outs[0])
    return _gather(parts)


def _gather(parts):
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(cols) for cols in zip(*parts))
    return torch.cat(parts)
