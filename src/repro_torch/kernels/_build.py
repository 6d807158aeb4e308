"""Build and load the port's hand-written CUDA kernels (nvcc + ctypes).

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/repro_torch/lib<name>-<hash>.so``
under the checkout.  The hash covers the sources and the flags, so a
changed source rebuilds and an unchanged one is reused.  :func:`build`
starts one ``nvcc`` per stale source, all at once, and waits for them.

No CUDA code runs at import: a library is built and loaded at its first
use, and a failed build raises with nvcc's output.  The loaded libraries
are the only state this module keeps.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# -fmad=false: no multiply-add contraction, so the kernels round every
# product and sum as the plain PyTorch versions do.  -Xptxas -v writes each
# kernel's registers and shared memory into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of its inputs."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names=None) -> dict[str, str]:
    """Compile every stale library in parallel; return each one's build log.

    Raises ``RuntimeError`` with nvcc's output when any compile fails.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: library_path(n).with_suffix(".log").read_text() for n in names}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if stale) and load ``lib<name>``, declaring its C entries.

    ``signatures`` maps each entry name to its ``argtypes``; every entry
    returns a ``cudaError_t`` as ``int``.  Pointers and the stream must be
    declared ``c_void_p``, or ctypes would pass them as 32-bit ints.
    """
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused or failed launch)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
