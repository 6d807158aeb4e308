"""Atomic, async checkpointing of a tree of tensors, restored onto a device.

The port's counterpart of the reference's ``runtime/checkpoint.py``, with
its layout, so either package reads the other's checkpoints:

    <dir>/step_000123/
        MANIFEST.json        tree structure, shapes, dtypes, step, extras
        <flat.key>.npy       one file per leaf
        _COMMITTED           written last; absence = partial checkpoint

  * **atomicity** -- writes go to ``step_X.tmp-<pid>`` and are renamed into
    place after the commit marker; a crashed writer never corrupts the
    latest checkpoint (``latest_step`` ignores uncommitted dirs);
  * **async** -- ``save_async`` copies the tree's tensors to host memory
    at once and writes it on a worker thread, one write in flight.  The
    copy is made on every device: on the CPU a tensor's ``.numpy()``
    shares its storage, and the next in-place optimizer step would change
    the arrays being written.  A numpy leaf is taken as it is, as the
    reference's ``device_get`` takes one: the caller hands it over (the
    Trainer's tree is assembled on the host for the write);
  * **restore onto a device** -- ``restore`` takes ``device=`` where the
    reference takes target shardings, or with ``mmap=True`` hands back the
    files' arrays memory-mapped, so a caller copies each device only its
    block of each leaf (a model laid out over a mesh,
    ``train/trainer.Trainer``);
  * **retention** -- ``keep`` newest k checkpoints are preserved.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors or numpy arrays.  numpy has no bfloat16: a bf16 leaf is stored
widened to float32, and ``restore`` casts each leaf to its skeleton leaf's
dtype where that leaf is a tensor.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.dispatcher import resolve_device

_SEP = "/"


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), prefix + (k,)))
    else:
        out[_SEP.join(prefix)] = tree
    return out


def _unflatten_into(skeleton, flat, prefix=()):
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in skeleton.items()}
    if hasattr(skeleton, "_fields"):
        return type(skeleton)(*[
            _unflatten_into(getattr(skeleton, k), flat, prefix + (k,))
            for k in skeleton._fields
        ])
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(
            _unflatten_into(v, flat, prefix + (str(i),))
            for i, v in enumerate(skeleton)
        )
    return flat[_SEP.join(prefix)]


def _map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_map_leaves(fn, getattr(tree, k), *(getattr(r, k) for r in rest))
                            for k in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _host_copy(x) -> np.ndarray:
    """A leaf on the host: a tensor copied (sharing no storage with it), a
    numpy array taken as it is, as the caller hands it over."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


def _restored(arr: np.ndarray, skel, device):
    """A loaded leaf as a tensor: on ``device``, else the skeleton leaf's
    device (the CPU for an array or a ``meta`` tensor); in the skeleton
    leaf's dtype where that leaf is a tensor."""
    t = torch.from_numpy(arr)
    if isinstance(skel, torch.Tensor):
        dev = device if device is not None else (
            skel.device if skel.device.type != "meta" else torch.device("cpu"))
        return t.to(device=dev, dtype=skel.dtype)
    return t.to(device) if device is not None else t


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ---- write ----
    def save(self, step: int, tree, extras: dict | None = None):
        """Synchronous atomic save."""
        self._write(step, _map_leaves(_host_copy, tree), extras or {})

    def save_async(self, step: int, tree, extras: dict | None = None):
        """Copy the tensors to the host now, write on a background thread."""
        self.wait()  # one in-flight write at a time
        host = _map_leaves(_host_copy, tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extras or {}), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step, host_tree, extras):
        flat = _flatten(host_tree)
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extras": extras, "leaves": {}}
        for key, arr in flat.items():
            fname = key.replace(_SEP, ".") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
        (tmp / "_COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---- read ----
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "_COMMITTED").exists() and ".tmp-" not in p.name:
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, skeleton, device=None, mmap: bool = False):
        """Load a checkpoint into the structure of ``skeleton``.

        Every leaf becomes a tensor on ``device`` (``'cuda'`` raises without
        a card), else on its skeleton leaf's device (the CPU for an array or
        a ``meta`` tensor), in the skeleton leaf's dtype where that leaf is
        a tensor.  With ``mmap``, every leaf is the file's numpy array,
        memory-mapped read-only and in the file's dtype (a bf16 leaf's
        float32), read only where it is sliced.  Returns (tree, extras).
        """
        device = None if device is None else resolve_device(device)
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        flat = {}
        for key, meta in manifest["leaves"].items():
            flat[key] = np.load(d / meta["file"], mmap_mode="r" if mmap else None)
        tree = _unflatten_into(skeleton, flat)
        if mmap:
            return tree, manifest["extras"]
        return _map_leaves(lambda a, s: _restored(a, s, device), tree, skeleton), \
            manifest["extras"]

    def restore_latest(self, skeleton, device=None, mmap: bool = False):
        """Load the newest readable checkpoint, walking back over torn ones.

        The ``_COMMITTED`` marker already screens out checkpoints whose
        writer died before the rename -- but a marker can survive while a
        leaf file is later truncated or lost (disk-full, partial rsync,
        bit-rot).  ``restore`` stays strict (a named step either loads or
        raises); ``restore_latest`` is the recovery path, so it falls
        back to the previous committed step when the newest fails to
        deserialize.  Returns ``None`` only when no step is readable.
        """
        last_err = None
        for step in reversed(self.all_steps()):
            try:
                tree, extras = self.restore(step, skeleton, device, mmap)
                return step, tree, extras
            except (OSError, ValueError, KeyError, json.JSONDecodeError,
                    EOFError) as e:
                last_err = e
                continue
        if last_err is not None:
            warnings.warn(
                f"no readable checkpoint (newest failed with: {last_err!r})",
                RuntimeWarning, stacklevel=2,
            )
        return None
