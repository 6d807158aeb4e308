"""One run of one cell: set-up, the window, the check, the result line.

``run_cell`` does everything but the look for a chip, so the tests can
drive a whole run on the CPU at a small size; ``radbench/run.py`` adds
that look, the command line and the last checks of the process.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from radbench import cases as caselib
from radbench import check
from radbench import drivers
from radbench import traffic
from radbench import work as worklib
from radbench import yardstick
from radbench.trace import Trace, spans

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_MODULES = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of it."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT + 0.0


_IMPORTED_AT = time.perf_counter()


@dataclasses.dataclass
class Spec:
    """A cell of ``BENCHMARK.json`` with its configuration, mix and metrics."""

    cell: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    root: Path

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Spec":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
        cell = cells[name]
        cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
        config = json.loads((root / cfg_entry["file"]).read_text())
        mix = traffic.load(cell["traffic"], root / "radbench")
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
        return cls(cell, config, mix, e2e, layer, root)


@dataclasses.dataclass
class Run:
    """What a per-layer or end-to-end reader reads (``metrics/<name>.py``)."""

    cell: str
    entry: str
    loop: str  # "closed" or "open"
    config: dict
    cases: int  # cases (requests) completed in the window
    window_s: float
    setup_s: float
    counters: dict
    latencies_s: list | None  # open loop: due time -> rows, each request
    trace: object | None  # trace.Summary of a traced run
    work: dict | None  # kernel -> (operations, bytes) handed in the traced window


def load_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` of ``radbench/metrics/<name>.py``."""
    path = root / "radbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"radbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _finite(x: float, cap: float = 1e300) -> float:
    return x if math.isfinite(x) else cap


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device="cuda",
             per_dim: int | None = None, dims=None, log=print) -> dict:
    """Set up, measure, check and report one run; returns the result line's
    object.  ``per_dim`` and ``dims`` shrink the pool (tests only)."""
    cfg, mix = spec.config, spec.mix
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_start = process_age_s()
    pool = caselib.build_pool(seed, tuple(map(tuple, dims or cfg["dims"])),
                              per_dim or int(mix["per_dim"]), tuple(cfg["spacing"]), dev)
    t_pool = process_age_s()
    driver = drivers.load(mix["entry"], spec.root / "radbench")(cfg, mix, pool, dev, seed)
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s: start and imports {t_start:.3f} s, a pool of {len(pool)} "
        f"cases {t_pool - t_start:.3f} s, entry {mix['entry']} built and warmed "
        f"{setup_s - t_pool:.3f} s")

    from repro_torch.runtime import autotune
    sweeps0 = autotune.SWEEPS
    tracer = Trace(trace)
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(spans(driver.spans))
        with tracer:
            with tracer.window():
                mark = torch.profiler.record_function if trace else contextlib.nullcontext
                done, window_s = driver.window(seconds, mark)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    sweeps = autotune.SWEEPS - sweeps0
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window {window_s:.3f} s, {done} cases, autotune sweeps inside it: {sweeps}")
    if driver.counters.get("job_s"):
        log(f"seconds a job: {[round(x, 3) for x in driver.counters['job_s']]}")

    summary = tracer.summary()
    work = None
    if trace and any(m["name"].endswith("_roofline") for m in spec.per_layer):
        work = census(driver, pool, cfg, dev)
    answers = driver.answers()
    failed = driver.failed()
    counters = dict(driver.counters)
    latencies = driver.latencies_s() if hasattr(driver, "latencies_s") else None
    driver_row = driver.row
    driver.close()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window and the peak: the reference in blocks, case by case
    t0 = time.perf_counter()
    families = tuple(cfg["families"])
    to_row = (check.single_row if driver_row == "single"
              else (lambda r: check.split_row(r, families)))
    due = sorted({i for i, _ in answers})
    want = dict(zip(due, check.reference_rows([pool[i] for i in due], families,
                                              cfg["n_bins"], dev)))
    rows = [(i, to_row(row)) for i, row in answers]
    numbers = check.worst([check.gaps(row, want[i], cfg["n_bins"]) for i, row in rows])
    correct, shown = check.verdict(numbers, cfg["limits"], done - len(answers))
    log(f"check {time.perf_counter() - t0:.3f} s over {len(due)} distinct cases, "
        f"{len(answers)} answers")

    run = Run(spec.cell["name"], mix["entry"], mix.get("loop", "closed"), cfg, done, window_s,
              setup_s, counters, latencies, summary, work)
    names = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for m in names:
        value = load_reader(m["name"], spec.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace and summary is not None:
        by_kernel = collections.Counter()
        for name, sec in summary.kernel_s.items():
            by_kernel[yardstick.kernel_of(name) or "other"] += sec
        log(f"device seconds by kernel in the traced window: {dict(by_kernel)}")
    if trace and work:
        log(f"card: {power_limit()}")
        for m in names:
            if m["name"].endswith("_roofline") and m["name"] in metrics:
                ops, nbytes = work[m["name"][: -len("_roofline")]]
                _, bound = yardstick.least_seconds((ops, nbytes))
                log(f"{m['name']}: {metrics[m['name']]['value']:.4f}% ({bound}-bound, "
                    f"{ops:.6g} operations, {nbytes:.6g} bytes)")
    result = {
        "correct": bool(correct),
        "attempted": int(done),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace and summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    for k, v in shown.items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    result["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                       for k, v in shown.items()}
    return result


def census(driver, pool, cfg, dev) -> dict:
    """The work the traced window handed each kernel (``radbench/work``):
    each of the driver's replay units runs once more under the recording,
    weighted by the times the window ran it."""
    families = tuple(cfg["families"])
    counts = collections.Counter(i for i, _ in driver.answers())
    handed = collections.Counter()
    for weight, unit in driver.replay_units():
        with worklib.recording() as rec:
            unit()
        handed += worklib.handed(rec, weight)
    censuses = {i: worklib.case_census(pool[i], families, dev) for i in counts}
    return worklib.window_work(counts, censuses, handed, families, cfg["n_bins"])


def jax_loaded() -> list[str]:
    """Top-level names of JAX or the JAX package among the loaded modules."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in JAX_MODULES})
