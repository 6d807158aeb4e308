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
reference's ``PartitionSpec`` as a :class:`PartitionSpec`, a tuple with one
entry a dimension (``None``, a mesh-axis name or a tuple of them).
:class:`NamedSharding` lays a tensor out over a mesh by such a spec
(``shard_shape``, ``place``, ``gather``), and :func:`named_sharding`,
:func:`param_shardings` and :func:`tree_shardings` give one for each leaf
of a parameter spec tree or an ``Ax``-annotated tree, as the reference's
do for its trainer and dry run.  A mesh that only names axis sizes
(:class:`AbstractMesh`, the production meshes) serves :func:`pspec` and
``shard_shape`` and touches no device.

:func:`shard_map_compat` is the counterpart of ``shard_map``: it runs a
function once a slot, one host thread a slot, each on its own local view
of the arguments, and inside it :func:`psum`, :func:`pmax`,
:func:`ppermute`, :func:`axis_index` and :func:`collective` act over a
named axis of the mesh.  A collective is a barrier: every slot hands in its
operand and then reduces all of its group's operands in slot order, so
every slot holds the same bits; no float atomics.  On the card a slot's
work is queued on its own stream (:meth:`Mesh.stream`), an operand read by
another slot is read behind an event recorded after it was made (a peer
copy where the slot is on another card), and the owner's stream waits for
every reader before it goes on, so no slot overwrites an operand that
another still reads.  An exception in any slot breaks the barrier; it is
re-raised in the caller once every thread has ended.

Tensor parallelism over the ``model`` axis is a :class:`ModelGroup`: the
slots of one data row, driven by one host thread as one autograd graph.
A value the group holds replicated is a list of one copy a slot; a
partial sum is a list of one addend a slot.  :meth:`ModelGroup.reduce`
adds the partials in slot order onto every slot (its backward hands each
slot its own copy's gradient), :meth:`ModelGroup.handout` hands replicated
copies to the slots' blocks of work (the identity; its backward adds the
slots' gradients in slot order), and :meth:`ModelGroup.first` takes the
first slot's copy (its backward hands the gradient to every copy): the two
operators of Megatron-LM's tensor parallelism and the pick of a replicated
scalar.  No barrier sits in any backward, so autograd's one worker thread
a card runs every slot's backward.  A model laid out over a mesh
(``models/tensor_parallel.lay_out``) runs each data row's group so.

:func:`constrain` is a no-op without a mesh, on a mesh of one slot, inside
a :func:`shard_map_compat` slot of a mesh whose ``model`` axis is 1 (the
local view) and inside a :class:`ModelGroup` slot (the slot's block,
checked).  A model that is not laid out, run under a mesh of more slots,
makes it raise ``NotImplementedError`` with how to lay it out.
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


class PartitionSpec(tuple):
    """The mesh axes of each dimension of a tensor: ``None`` (replicated),
    a mesh-axis name, or a tuple of names (the dimension split over their
    product, the first name outermost).  The reference's ``PartitionSpec``
    as a tuple: it equals the plain tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


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
          shape: tuple | None = None) -> PartitionSpec:
    """The mesh axes of each dimension of a tuple of logical axis names:
    the reference's ``PartitionSpec``.

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
    return PartitionSpec(*parts)


def constrain(x, *axes):
    """Sharding constraint by logical axes: ``x`` itself without an active
    mesh, on a mesh of one slot, inside a :func:`shard_map_compat` slot (the
    local view) whose mesh has no ``model`` axis of more than one, and
    inside a :class:`ModelGroup` slot, where each dimension whose logical
    axis has a whole size in the group's ``sizes`` must be the slot's block
    of it (the whole where ``pspec`` does not split it over ``model``).
    Elsewhere a model that is not laid out runs on a mesh of several slots:
    ``NotImplementedError``, saying how to lay it out."""
    group = _MODEL_SLOT.group
    if group is not None:
        for i, name in enumerate(axes):
            whole = group.sizes.get(name)
            if whole is None:
                continue
            over = "model" in _axes_of(pspec((name,), mesh=group.mesh, shape=(whole,))[0])
            if x.shape[i] != (whole // group.size if over else whole):
                raise ValueError(f"constrain: dimension {i} ({name}) of {tuple(x.shape)} is "
                                 f"not a slot's block of {whole} over a {group.size}-slot "
                                 f"model axis")
        return x
    group = _SLOT.group
    mesh = group.mesh if group is not None else active_mesh()
    if group is not None and mesh.shape.get("model", 1) == 1:
        return x
    if group is None and (mesh is None or math.prod(mesh.shape.values()) == 1):
        return x
    raise NotImplementedError(
        f"constrain{tuple(pspec(tuple(axes), mesh=mesh, shape=tuple(x.shape)))} on a mesh of "
        f"{mesh.shape} of a model that is not laid out: lay it out over the mesh with "
        f"repro_torch.models.tensor_parallel.lay_out(model, mesh) (every family), or run it "
        f"without a multi-slot mesh")


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


# ---------------------------------------------------------------------------
# layouts over a mesh: the trainer's and the dry run's shardings
# ---------------------------------------------------------------------------

class AbstractMesh:
    """A mesh that only names its axes' sizes: what :func:`pspec` and
    :meth:`NamedSharding.shard_shape` read of a mesh, with no device (the
    production meshes of ``launch/mesh.make_production_mesh``)."""

    def __init__(self, shape, axis_names):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(n) for n in shape)
        if len(sizes) != len(self.axis_names) or len(set(self.axis_names)) != len(sizes):
            raise ValueError(f"one distinct axis name a dimension: {sizes}, {self.axis_names}")
        self._sizes = sizes

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def _axes_of(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


class NamedSharding:
    """The layout of a tensor over ``mesh`` by ``spec`` (a
    :class:`PartitionSpec` or a tuple, one entry a dimension; missing
    trailing entries are ``None``).  A dimension split over mesh axes is
    cut into equal contiguous blocks, one a slot in slot order (the first
    axis outermost); over the other axes each block is a whole copy."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def _entries(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec!r} has more entries than a tensor of {ndim} dimensions")
        return [_axes_of(e) for e in self.spec] + [()] * (ndim - len(self.spec))

    def shard_shape(self, global_shape) -> tuple:
        """The shape of one shard of a tensor of ``global_shape``; raises
        where a split dimension is not a multiple of its axes' product."""
        sizes = self.mesh.shape
        out = []
        for dim, axes in zip(global_shape, self._entries(len(global_shape))):
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(global_shape)} does not split over "
                                 f"{axes} ({n} slots) by {self.spec!r}")
            out.append(dim // n)
        return tuple(out)

    def block(self, index, global_shape) -> tuple:
        """The slices of the block that the slot at ``index`` (an index
        tuple of the mesh's devices) holds."""
        sizes = self.mesh.shape
        coord = dict(zip(self.mesh.axis_names, index))
        local = self.shard_shape(global_shape)
        out = []
        for n, axes in zip(local, self._entries(len(global_shape))):
            k = 0
            for a in axes:
                k = k * sizes[a] + coord[a]
            out.append(slice(k * n, (k + 1) * n))
        return tuple(out)

    def place(self, tensor, dtype=None):
        """One shard a slot: an object array shaped as the mesh's devices,
        each entry a new contiguous tensor on its slot's device (a copy even
        where the slot holds the whole tensor, so no two slots alias), in
        ``dtype`` (default the tensor's).  A numpy array (a memory-mapped
        one too) is sliced on the host, so each slot reads its block
        alone."""
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for index in np.ndindex(out.shape):
            part = tensor[self.block(index, tuple(tensor.shape))]
            if not isinstance(part, torch.Tensor):
                part = torch.from_numpy(np.array(part))
            shard = torch.empty(part.shape, dtype=dtype or part.dtype,
                                device=self.mesh.devices[index])
            out[index] = shard.copy_(part)
        return out

    def global_shape(self, shards) -> tuple:
        """The shape of the global tensor of ``shards``."""
        first = shards.flat[0]
        sizes = self.mesh.shape
        return tuple(d * math.prod(sizes[a] for a in axes)
                     for d, axes in zip(first.shape, self._entries(first.dim())))

    def pieces(self, shards) -> list:
        """``(slices of the global tensor, shard)`` for each distinct block
        of ``shards`` (as :meth:`place` gives them): the slots at index 0
        of the axes that do not split the tensor."""
        first = shards.flat[0]
        shape = self.global_shape(shards)
        split = {a for axes in self._entries(first.dim()) for a in axes}
        out = []
        for index in np.ndindex(shards.shape):
            coord = dict(zip(self.mesh.axis_names, index))
            if not any(coord[a] for a in self.mesh.axis_names if a not in split):
                out.append((self.block(index, shape), shards[index]))
        return out

    def read(self, shards, cut, device=None) -> torch.Tensor:
        """The region ``cut`` (a slice a dimension, with start and stop, of
        the global tensor) of ``shards`` (as :meth:`place` gives them), as a
        new tensor on ``device`` (default the mesh's first slot): each piece
        copied from the one shard that holds it (:meth:`pieces`)."""
        device = self.mesh.home if device is None else resolve_device(device)
        first = shards.flat[0]
        out = torch.empty(tuple(c.stop - c.start for c in cut), dtype=first.dtype,
                          device=device)
        for blk, shard in self.pieces(shards):
            lo = [max(b.start, c.start) for b, c in zip(blk, cut)]
            hi = [min(b.stop, c.stop) for b, c in zip(blk, cut)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            out[tuple(slice(a - c.start, b - c.start) for a, b, c in zip(lo, hi, cut))].copy_(
                shard[tuple(slice(a - k.start, b - k.start) for a, b, k in zip(lo, hi, blk))])
        return out

    def gather(self, shards, device=None) -> torch.Tensor:
        """The global tensor of ``shards`` (as :meth:`place` gives them) on
        ``device`` (default the mesh's first slot)."""
        device = self.mesh.home if device is None else resolve_device(device)
        first = shards.flat[0]
        if not any(self._entries(first.dim())) and first.device == device:
            return first
        return self.read(shards, tuple(slice(0, n) for n in self.global_shape(shards)), device)


def named_sharding(axes: tuple, mesh=None, rules=None) -> NamedSharding:
    """The layout of a tensor with logical ``axes`` over ``mesh`` (default
    the ambient one, which must exist)."""
    mesh = mesh or active_mesh()
    if mesh is None:
        raise ValueError("named_sharding needs a mesh")
    return NamedSharding(mesh, pspec(tuple(axes), rules=rules, mesh=mesh))


def param_shardings(spec_tree, mesh, rules=None):
    """A :class:`NamedSharding` for each leaf of a parameter spec tree
    (``models/params.P`` leaves, layers stacked), under ``rules`` over
    :data:`DEFAULT_RULES`; the nested dict of the spec's paths."""
    from repro_torch.models import params as pmod

    rules = dict(DEFAULT_RULES, **(rules or {}))
    flat = {path: NamedSharding(mesh, pspec(leaf.axes, rules=rules, mesh=mesh, shape=leaf.shape))
            for path, leaf in pmod.tree_paths(spec_tree)}
    return pmod._unflatten(flat)


def tree_shardings(abstract_tree, axes_tree, mesh, rules=None):
    """A :class:`NamedSharding` for each tensor of ``abstract_tree`` from
    the :class:`Ax` leaf at the same place of ``axes_tree``."""
    rules = dict(DEFAULT_RULES, **(rules or {}))

    def one(t, ax):
        if not isinstance(ax, Ax):
            raise TypeError(f"an axes tree holds Ax leaves, got {ax!r}")
        return NamedSharding(mesh, pspec(ax.axes, rules=rules, mesh=mesh, shape=tuple(t.shape)))

    return tree_map(one, abstract_tree, axes_tree)


# ---------------------------------------------------------------------------
# trees: nested dicts, lists, tuples and NamedTuples of leaves
# ---------------------------------------------------------------------------

def _is_node(x) -> bool:
    return isinstance(x, (dict, list)) or (isinstance(x, tuple)
                                           and not isinstance(x, PartitionSpec))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the leaves at the same places
    of ``rest``, keeping the structure.  A leaf is anything but a dict, a
    list or a tuple (a :class:`PartitionSpec` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)])
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order (a dict's by sorted
    key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_node(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if hasattr(node, "_fields"):
            return type(node)(*[rebuild(v) for v in node])
        if _is_node(node):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(tree)


def _spec_tree(spec, tree):
    """``spec`` (a :class:`PartitionSpec` or a tree of them, a prefix of
    ``tree``) as one spec a leaf of ``tree``."""
    if spec is None or isinstance(spec, PartitionSpec):
        return tree_map(lambda _: PartitionSpec() if spec is None else spec, tree)
    if isinstance(spec, dict):
        return {k: _spec_tree(spec[k], v) for k, v in tree.items()}
    return type(tree)(*[_spec_tree(s, v) for s, v in zip(spec, tree)]) \
        if hasattr(tree, "_fields") else type(tree)(_spec_tree(s, v) for s, v in zip(spec, tree))


# ---------------------------------------------------------------------------
# shard_map_compat: one host thread a slot, collectives over named axes
# ---------------------------------------------------------------------------

class _Slot(threading.local):
    group = None  # the running shard_map's _Group, inside a slot
    index = None  # this slot's index tuple


_SLOT = _Slot()


class _Group:
    """The state the slots of one :func:`shard_map_compat` call share."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.barrier = threading.Barrier(mesh.devices.size)
        self.posted: dict = {}  # index -> (operand tree, event or None)
        self.done: dict = {}  # index -> event or None

    def members(self, index, axis) -> list:
        """The index tuples of ``index``'s group along ``axis``, in order."""
        a = self.mesh.axis_names.index(axis)
        return [index[:a] + (k,) + index[a + 1:] for k in range(self.mesh.devices.shape[a])]


def _current():
    group, index = _SLOT.group, _SLOT.index
    if group is None:
        raise RuntimeError("a collective runs only inside a shard_map_compat slot")
    return group, index


def _record(dev):
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


class _Operands:
    """The operands of a collective's group, each fetched to this slot's
    device at its first read: on the same card a view, its storage recorded
    on this slot's stream; from another card a peer copy queued on this
    thread's stream of that card behind the owner's event."""

    def __init__(self, group, members, dev):
        self._group, self._members, self._dev = group, members, dev
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self._members)

    def __getitem__(self, k):
        if k not in self._cache:
            self._cache[k] = self.select(k, lambda tree: tree)
        return self._cache[k]

    def select(self, k, pick, device=None):
        """``pick`` of the ``k``-th operand tree, fetched to ``device``
        (default this slot's): only the tensors (or views) that ``pick``
        returns cross from another card."""
        tree, ev = self._group.posted[self._members[k]]
        dev = self._dev if device is None else device
        return tree_map(lambda x: self._fetch(x, ev, dev), pick(tree))

    @staticmethod
    def _fetch(x, ev, dev):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            return x
        stream = torch.cuda.current_stream(x.device)
        stream.wait_event(ev)
        x.record_stream(stream)
        return x if x.device == dev else x.to(dev, non_blocking=True)


def collective(tree, axis: str, combine):
    """The building block of the collectives: inside a slot, hand in
    ``tree`` (tensors on the slot's device) and return ``combine(ops)``,
    computed on this slot, where ``ops[k]`` is the tree that the ``k``-th
    slot of this slot's group along ``axis`` handed in (the group's slots
    are those that differ only in ``axis``), and ``ops.select(k, pick)``
    the part of it that ``pick`` takes (views of it: only those cross
    cards).
    ``combine`` must not write to the operands.  Every slot of the mesh
    calls the same collectives in the same order."""
    group, index = _current()
    if axis not in group.mesh.shape:
        raise ValueError(f"no axis {axis!r} in the mesh {group.mesh.shape}")
    dev = group.mesh.devices[index]
    group.posted[index] = (tree, _record(dev))
    group.barrier.wait()
    members = group.members(index, axis)
    out = combine(_Operands(group, members, dev))
    group.done[index] = _record(dev)
    group.barrier.wait()
    if dev.type == "cuda":  # no operand of this slot is written before its readers are done
        stream = torch.cuda.current_stream(dev)
        for j in members:
            if j != index:
                stream.wait_event(group.done[j])
    return out


def _ordered(fn):
    def combine(ops):
        acc = tree_map(lambda x: x.clone(), ops[0])
        for k in range(1, len(ops)):
            acc = tree_map(fn, acc, ops[k])
        return acc
    return combine


def psum(x, axis: str):
    """The sum of ``x`` (a tensor or a tree of them) over the slots of
    ``axis``, added in slot order: every slot gets the same bits."""
    return collective(x, axis, _ordered(lambda a, b: a.add_(b)))


def pmax(x, axis: str):
    """The elementwise maximum of ``x`` over the slots of ``axis``."""
    return collective(x, axis, _ordered(torch.maximum))


def axis_index(axis: str) -> int:
    """This slot's index along ``axis``."""
    group, index = _current()
    return index[group.mesh.axis_names.index(axis)]


def ppermute(x, axis: str, perm):
    """``x`` sent along ``axis`` by ``perm``, pairs ``(source, destination)``
    of axis indices: each slot gets a copy of its source's ``x``, or zeros
    where no pair names it as a destination."""
    me = axis_index(axis)
    src = [s for s, d in perm if d == me]

    def combine(ops):
        if not src:
            return tree_map(torch.zeros_like, x)
        return tree_map(lambda t: t.clone(), ops[src[0]])

    return collective(x, axis, combine)


def _local_view(x, sharding, index, dev, ready):
    """The slot's block of a global argument leaf on its device: a view on
    the same card (its storage recorded on the slot's stream), a copy from
    elsewhere, queued behind the caller's event on the source's stream."""
    if not isinstance(x, torch.Tensor):
        return x
    part = x[sharding.block(index, tuple(x.shape))]
    if x.device.type == "cuda":
        stream = torch.cuda.current_stream(x.device)
        stream.wait_event(ready[x.device])
        part.record_stream(stream)
    if x.device == dev:
        return part
    return part.to(dev, non_blocking=x.device.type == "cuda")


@contextlib.contextmanager
def _slot_streams(mesh, index):
    """On the card: the slot's device and stream current, and its link
    stream current on the first device (the stream of its peer copies)."""
    dev = mesh.devices[index]
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(mesh.link(index)), \
            torch.cuda.stream(mesh.stream(index)):
        yield


def shard_map_compat(f, mesh, in_specs, out_specs, check: bool = True):
    """Counterpart of the reference's ``shard_map``: the returned function
    runs ``f`` once a slot of ``mesh`` (a :class:`Mesh`), each in a host
    thread of its own, on the slot's local view of each argument.

    ``in_specs`` is a :class:`PartitionSpec` for every argument or a tuple
    of one spec (or a tree of them, a prefix of the argument) an argument;
    each tensor leaf is cut as :class:`NamedSharding` lays it out and its
    block handed to the slot on the slot's device.  Inside ``f`` the
    collectives (:func:`psum`, :func:`pmax`, :func:`ppermute`,
    :func:`axis_index`, :func:`collective`) act over the mesh's named
    axes, and :func:`constrain` sees the local view.  ``out_specs`` lays out
    ``f``'s outputs in the same way: each output is rebuilt on the mesh's
    first slot from the slots' blocks (a replicated output is the first
    slot's).  On the card each slot runs on its own stream (see the module
    docstring); the caller's current streams wait for every slot before
    the outputs return.  Grad mode and the ambient rules carry into the
    slots.  An exception in a slot stops the others at their next
    collective and is re-raised here, after every thread has ended.
    ``check`` is accepted for the reference's signature; the port does not
    check that a replicated output is replicated.
    """
    del check

    def mapped(*args):
        specs = (in_specs,) * len(args) if isinstance(in_specs, PartitionSpec) else tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError(f"{len(specs)} in_specs for {len(args)} arguments")
        arg_sh = [tree_map(lambda s: NamedSharding(mesh, s), _spec_tree(s, a))
                  for s, a in zip(specs, args)]
        # every device's caller stream, so that a slot reads what the caller
        # queued before this call (its arguments, a replica, a state)
        devices = {x.device for x in tree_leaves(args) if isinstance(x, torch.Tensor)}
        devices |= set(mesh.devices.flat)
        ready = {d: _record(d) for d in devices if d.type == "cuda"}
        group = _Group(mesh)
        grad, rules = torch.is_grad_enabled(), _CTX.rules
        indices = list(np.ndindex(mesh.devices.shape))
        results: dict = {}
        errors: list = []

        def run(index):
            _SLOT.group, _SLOT.index, _CTX.rules = group, index, rules
            dev = mesh.devices[index]
            try:
                with torch.set_grad_enabled(grad), _slot_streams(mesh, index):
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).wait_event(ready[dev])
                        torch.cuda.current_stream(mesh.home).wait_event(ready[mesh.home])
                    local = [tree_map(lambda x, sh: _local_view(x, sh, index, dev, ready), a, sh)
                             for a, sh in zip(args, arg_sh)]
                    out = f(*local)
                    results[index] = (out, _record(dev))
            except BaseException as e:  # re-raised in the caller
                errors.append((index, e))
                group.barrier.abort()
            finally:
                _SLOT.group = _SLOT.index = None

        threads = [threading.Thread(target=run, args=(index,), name=f"slot{index}")
                   for index in indices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            real = [(i, e) for i, e in errors if not isinstance(e, threading.BrokenBarrierError)]
            index, err = min(real or errors, key=lambda ie: ie[0])
            err.add_note(f"in slot {index} of a shard_map_compat over {mesh.shape}")
            raise err
        for index, (out, ev) in results.items():
            if ev is None:
                continue
            # the caller's streams go on after every slot's work
            for d in {mesh.devices[index], mesh.home}:
                torch.cuda.current_stream(d).wait_event(ev)
            for x in tree_leaves(out):  # read by the caller's streams from here on
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    torch.cuda.current_stream(x.device).wait_event(ev)
                    x.record_stream(torch.cuda.current_stream(x.device))
        outs = results[indices[0]][0]

        def gather(spec, *leaves):
            shards = np.empty(mesh.devices.shape, dtype=object)
            for index, leaf in zip(indices, leaves):
                shards[index] = leaf
            return NamedSharding(mesh, spec).gather(shards, mesh.home)

        per_slot = [results[i][0] for i in indices]
        return tree_map(gather, _spec_tree(out_specs, outs), *per_slot)

    return mapped


# ---------------------------------------------------------------------------
# model groups: tensor parallelism over the 'model' axis
# ---------------------------------------------------------------------------

class _ModelSlot(threading.local):
    group = None  # the ModelGroup whose slot runs, inside ModelGroup.slot
    k = None  # that slot's index along 'model'


_MODEL_SLOT = _ModelSlot()


def _ordered_sum(parts, device):
    """``parts`` added in slot order into a new tensor on ``device``; a
    half-precision sum is taken in float32 and rounded once, as one GEMM
    over the whole contraction accumulates."""
    dtype = parts[0].dtype
    wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    acc = parts[0].to(device=device, dtype=wide, copy=True)
    for p in parts[1:]:
        acc.add_(p.to(device, non_blocking=True))
    return acc if wide == dtype else acc.to(dtype)


class _Reduce(torch.autograd.Function):
    """Partials in, their sum on every slot out; each partial's gradient is
    its own slot's copy's (Megatron-LM's ``g``)."""

    @staticmethod
    def forward(ctx, devices, *parts):
        return tuple(_ordered_sum(parts, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _Handout(torch.autograd.Function):
    """Replicated copies in, the same copies out to the slots' blocks of
    work; each copy's gradient is every slot's gradient added in slot order
    (Megatron-LM's ``f``)."""

    @staticmethod
    def forward(ctx, devices, *xs):
        ctx.devices = devices
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(_ordered_sum(grads, d) for d in ctx.devices))


class _First(torch.autograd.Function):
    """Replicated copies in, the first slot's out; every copy's gradient is
    the output's."""

    @staticmethod
    def forward(ctx, devices, *xs):
        ctx.devices = devices
        return xs[0].view_as(xs[0])

    @staticmethod
    def backward(ctx, g):
        return (None, g, *(g.to(d, copy=True) for d in ctx.devices[1:]))


class ModelGroup:
    """The slots of one row of ``mesh`` along its ``model`` axis: the model
    group of one data slot, driven by one host thread.

    ``row`` is an index tuple of the mesh's devices (default the first);
    the group is the slots that differ from it only along ``model``, in
    order (one slot on a mesh without that axis).  Without a mesh the group
    is one slot of a model that is not laid out (``transformer.Decoder``):
    its operators are identities and :func:`constrain` sees the whole
    model, as outside any group.  ``sizes`` maps logical
    axes to their whole sizes, which :func:`constrain` checks a slot's
    blocks against.  A replicated value is a
    list of one copy a slot, a partial sum a list of one addend a slot,
    each on its slot's device.  :meth:`each` runs a function once a slot in
    slot order; the operators below are ``torch.autograd.Function``s, so a
    group's forward and backward are one autograd graph, and no barrier
    sits in its backward.  On the card each slot's work is queued on its
    device's current stream (the slots of one card share it); a copy
    between cards is ordered on both cards' current streams by PyTorch.
    """

    def __init__(self, mesh=None, row=None, sizes=None):
        self.mesh = mesh
        self.sizes = dict(sizes or {})
        if mesh is None:
            self.indices, self.devices = [()], (None,)
            return
        row = (0,) * mesh.devices.ndim if row is None else tuple(row)
        if "model" in mesh.shape:
            a = mesh.axis_names.index("model")
            self.indices = [row[:a] + (m,) + row[a + 1:] for m in range(mesh.shape["model"])]
        else:
            self.indices = [row]
        self.devices = tuple(mesh.devices[i] for i in self.indices)

    @property
    def size(self) -> int:
        return len(self.indices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"ModelGroup({self.indices}, devices={[str(d) for d in self.devices]})"

    @contextlib.contextmanager
    def slot(self, k: int):
        """Inside: slot ``k`` runs (:func:`constrain` checks its blocks)."""
        old = (_MODEL_SLOT.group, _MODEL_SLOT.k)
        _MODEL_SLOT.group, _MODEL_SLOT.k = self, k
        try:
            yield self.devices[k]
        finally:
            _MODEL_SLOT.group, _MODEL_SLOT.k = old

    def each(self, fn, *lists) -> list:
        """``[fn(a[k], b[k], ...) for each slot k]``, each inside
        :meth:`slot`."""
        if self.mesh is None:
            return [fn(*(a[0] for a in lists))]
        out = []
        for k in range(self.size):
            with self.slot(k):
                out.append(fn(*(a[k] for a in lists)))
        return out

    def copies(self, x) -> list:
        """A tensor that needs no gradient (an input) on every slot: ``x``
        itself on its own device, a copy elsewhere."""
        return [x if x.device == d else x.to(d, non_blocking=True) for d in self.devices]

    def reduce(self, parts) -> list:
        """The sum of the partials, added in slot order on every slot.
        Without autograd recording (serving) the slots of one device share
        one sum."""
        if self.size == 1:
            return list(parts)
        if torch.is_grad_enabled():
            return list(_Reduce.apply(self.devices, *parts))
        sums: dict = {}
        return [sums[d] if d in sums else sums.setdefault(d, _ordered_sum(parts, d))
                for d in self.devices]

    def handout(self, xs) -> list:
        """Replicated copies handed to the slots' blocks of work: the same
        values; in the backward every slot's gradient, added in slot order."""
        if self.size == 1 or not torch.is_grad_enabled():
            return list(xs)
        return list(_Handout.apply(self.devices, *xs))

    def first(self, xs):
        """The first slot's copy of a replicated value, used once (a loss
        term); in the backward every copy gets its gradient."""
        if self.size == 1 or not torch.is_grad_enabled():
            return xs[0]
        return _First.apply(self.devices, *xs)

    def gather(self, parts, dim: int, device=None) -> torch.Tensor:
        """The slots' blocks of a tensor split along ``dim``, concatenated
        in slot order on ``device`` (default the first slot's)."""
        device = self.home if device is None else device
        if self.size == 1:
            return parts[0] if parts[0].device == device else parts[0].to(device)
        return torch.cat([p.to(device, non_blocking=True) for p in parts], dim)

    @torch.no_grad()
    def pmax(self, xs) -> list:
        """The elementwise maximum over the slots, on every slot (no
        gradient)."""
        if self.size == 1:
            return list(xs)
        out = []
        for d in self.devices:
            acc = xs[0].to(d, copy=True)
            for x in xs[1:]:
                torch.maximum(acc, x.to(d, non_blocking=True), out=acc)
            out.append(acc)
        return out
