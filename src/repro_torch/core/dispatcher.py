"""Device resolution for the port's entry points.

The JAX package probes for a TPU and falls back to its CPU reference path
(``repro.core.dispatcher.resolve_backend``).  The port does not fall back:
an entry point runs on the card unless the caller asks for the CPU.

    None / 'cuda' / 'cuda:N' -- the hand-written CUDA kernels; raises
                                RuntimeError when no CUDA device exists
    'cpu'                    -- the plain PyTorch versions (tests, oracles)
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
