"""Device resolution for the port's entry points.

The JAX package probes for a TPU and falls back to its CPU reference path
(``repro.core.dispatcher.resolve_backend``).  The port does not fall back:
an entry point runs on the card unless the caller asks for the CPU.

    None / 'cuda' / 'cuda:N' -- the hand-written CUDA kernels; raises
                                RuntimeError when no CUDA device exists
    'cpu'                    -- the plain PyTorch versions (tests, oracles)

Kernel configurations: :func:`diameter_config`, :func:`compact_config`,
:func:`firstorder_config` and :func:`glcm_config` resolve ``'auto'``
through the measured autotune cache (``repro_torch.runtime.autotune``) on
the card and to the fixed defaults on the CPU, which has no axis to tune;
an explicit value always passes through.  They may run a measuring sweep
on a cache miss, which synchronises the card.

Cost-model inputs: :func:`sync_cost` (the per-fetch device-to-host
latency) and :func:`hw_profile` (the roofline profile) resolve through the
same cache; on a miss they probe the card, which synchronises it, so the
executor resolves them before it prepares a window.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default ``'cuda'``) to a usable ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def to_device(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Host data (numpy, a list, a CPU tensor) as a tensor on ``device``,
    queued without a host sync.

    A pageable host-to-device copy synchronises the stream, so on the card
    the data goes through a pinned staging buffer and a ``non_blocking``
    copy; PyTorch's pinned allocator keeps the buffer until the copy is
    done.  A strided host view is made contiguous first: copying one to the
    card would stage it through pageable memory and sync.  A tensor already
    on the card is only moved to ``device``.
    """
    x = torch.as_tensor(x, dtype=dtype)
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    return x.contiguous().pin_memory().to(device, non_blocking=True)


def stream_shared(value, device):
    """``(value, ready)`` for a cache of device tensors that every stream
    reads: ``value`` holds tensors whose copies were just queued on the
    current stream of ``device``, ``ready`` the CUDA event behind them (None
    off the card).  A copy queued on one stream is not ordered before
    another stream's reads, so every reader goes through
    :func:`await_shared` (the data-parallel slots of ``parallel/sharding``
    launch on streams of their own)."""
    if torch.device(device).type != "cuda":
        return value, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return value, ready


def await_shared(shared, device):
    """The value of a :func:`stream_shared` pair, once the current stream of
    ``device`` has been made to wait for its copies (no host sync)."""
    value, ready = shared
    if ready is not None:
        torch.cuda.current_stream(device).wait_event(ready)
    return value


def diameter_config(device, bucket: int, variant: str = "auto", block: int | None = None,
                    batch: int = 1, static: bool = False):
    """``(variant, block)`` of the diameter kernel for a vertex bucket.

    ``variant='auto'`` reads the autotune cache for the (vertex bucket,
    batch-depth bucket) pair, sweeping on a miss (``static=True``: the
    bucket is a static schedule's target, tuned on lists as empty as
    those, ``autotune.static_probe_extent``); an explicit variant passes through at the
    default block.  An explicit ``block`` always wins over the tuned one.
    """
    from repro_torch.runtime import autotune  # local import: avoids a cycle

    if variant != "auto":
        return variant, (block or autotune.DEFAULT_CONFIG.block)
    cfg = autotune.get_diameter_config(int(bucket), device, batch=batch, static=static)
    return cfg.variant, (block or cfg.block)


def compact_config(device, bucket: int, block="auto", batch: int = 1) -> int:
    """Keep flags a block of the compaction kernel takes for an input
    vertex bucket: the tuned value for ``block='auto'``, else ``block``."""
    from repro_torch.runtime import autotune

    if block is not None and block != "auto":
        return int(block)
    return autotune.get_compact_config(int(bucket), device, batch=batch).block


def firstorder_config(device, shape, block="auto", batch: int = 1) -> int:
    """Voxels per block of the first-order kernel for a padded-volume
    shape (keyed by its ``autotune.mc_shape_bucket``): the tuned value for
    ``block='auto'``, else ``block``."""
    from repro_torch.runtime import autotune

    if block is not None and block != "auto":
        return int(block)
    return autotune.get_family_config("firstorder", autotune.mc_shape_bucket(shape), device,
                                      batch=batch).block


def glcm_config(device, shape, block="auto", batch: int = 1) -> int:
    """CUDA blocks an SM the GLCM launch aims at; the contract of
    :func:`firstorder_config` against the ``glcm`` namespace."""
    from repro_torch.runtime import autotune

    if block is not None and block != "auto":
        return int(block)
    return autotune.get_family_config("glcm", autotune.mc_shape_bucket(shape), device,
                                      batch=batch).block


def sync_cost(device, cache=None) -> float:
    """Per-fetch device-to-host latency (microseconds) of ``device``: the
    ``sync/<device>`` record, else a probe on the card, else the default
    (``autotune.get_sync_cost``)."""
    from repro_torch.runtime import autotune

    return autotune.get_sync_cost(device, cache=cache)


def hw_profile(device, cache=None) -> dict | None:
    """Roofline profile (peak FP32 rate, memory bandwidth) of ``device``:
    the ``hw/<device>`` record, else a probe on the card, else the default;
    ``None`` under ``REPRO_ROOFLINE=0`` (``autotune.get_hw_profile``)."""
    from repro_torch.runtime import autotune

    return autotune.get_hw_profile(device, cache=cache)
