"""Meshes: ``make_host_mesh`` over the devices this process sees, and the
production meshes by shape alone.

Counterpart of ``repro.launch.mesh``.  ``make_production_mesh`` gives the
reference's single-pod (16, 16) ``('data', 'model')`` and multi-pod (2, 16,
16) ``('pod', 'data', 'model')`` meshes as :class:`AbstractMesh`es, which
name the axes' sizes and hold no device: the dry run lays its cells out
over them, cell for cell with the reference's.  The reference's ``HW``
constants are a TPU's and are not ported; where the dry run needs a peak
it reads the H100 profile of ``runtime/autotune.py``.  Importing this
module touches no device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dispatcher import resolve_device
from repro_torch.parallel.sharding import AbstractMesh, Mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh by shape: (16, 16) ``('data',
    'model')``, or with ``multi_pod`` (2, 16, 16) ``('pod', 'data',
    'model')``; no device is touched."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(model_parallel: int = 1, device: str = "cuda",
                   slots: int | None = None) -> Mesh:
    """A ``('data', 'model')`` mesh over every visible card, or, with
    ``device='cpu'``, over ``slots`` CPU slots (default 1; the tests' N
    slots).  ``model_parallel`` must divide the slot count; the data axis
    takes the rest.  Raises without a card unless ``device='cpu'``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if slots is not None:
            raise ValueError("slots= is for CPU meshes; a CUDA mesh covers every visible card")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev] * (1 if slots is None else int(slots))
    n = len(devices)
    if model_parallel < 1 or n == 0 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} device(s)")
    return grid_mesh(devices, model_parallel)


def grid_mesh(devices, model_parallel: int = 1, axis_names=("data", "model")) -> Mesh:
    """A ``(data, model)`` mesh of ``model_parallel`` columns over the first
    ``model_parallel * (len(devices) // model_parallel)`` of ``devices``, in
    order; the trailing rest is dropped.  Raises where no row is whole."""
    devices = list(devices)
    n = (len(devices) // model_parallel) * model_parallel if model_parallel >= 1 else 0
    if n == 0:
        raise ValueError(f"{len(devices)} device(s) cannot form a mesh with "
                         f"model_parallel={model_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(n // model_parallel, model_parallel), axis_names)
