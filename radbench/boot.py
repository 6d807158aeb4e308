"""The process set-up the command-line scripts share (``run.py``,
``sweep.py``, ``control.py``): the import path and the caches that have to
outlast a run.

A script run as ``python3 radbench/<script>.py`` has its own folder first
on ``sys.path``, where ``trace.py`` would shadow the standard library's
``trace``; ``prepare`` takes that entry out and puts the checkout's ``src``
(the port) and its root (this package) first.  The autotune cache goes to
a fixed file inside the checkout, so that only a checkout's first run of a
cell sweeps.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AUTOTUNE_CACHE = ROOT / "radbench" / ".cache" / "autotune.json"
# intra-op threads of a measuring process: on an 8-core host 4 ran the shape
# cohort 15% faster than 1 with no wider spread (PERF.md, section 2)
THREADS = 4


def prepare() -> None:
    """Set the import path and the autotune cache."""
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(AUTOTUNE_CACHE)
    here = ROOT / "radbench"
    sys.path[:] = [p for p in sys.path if not p or Path(p).resolve() != here]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
