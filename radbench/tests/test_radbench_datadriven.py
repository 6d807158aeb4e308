"""The benchmark is driven by data: a new configuration, traffic mix,
per-layer metric and cell are found by name, with no edit to any file
that is there; and ``BENCHMARK.json`` keeps to the contract's forms."""
import json
import re
import shutil
from pathlib import Path

import pytest

from radbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TINY_DIMS = [[18, 16, 12], [14, 12, 9]]


# a program entry the harness has no driver for: the whole job as one
# ``BatchedExtractor.run`` window
WHOLE_RUN_ENTRY = """
import contextlib
import time

from radbench import drivers, traffic


class Driver:
    row = "split"
    spans = [(drivers.EXECUTOR, "crop_to_roi", "radbench.crop_to_roi")]

    def __init__(self, config, mix, pool, device, seed):
        self.ext = drivers.batched(config, device)
        self.job = traffic.job_order(len(pool), int(mix["passes"]), seed)
        self.cases = [pool[i].triple for i in self.job]
        self.counters, self.jobs = {"runs": 0}, []

    def setup(self):
        self.ext.run(self.cases)

    def window(self, seconds, mark=contextlib.nullcontext):
        t0 = time.perf_counter()
        while not self.jobs or time.perf_counter() - t0 < seconds:
            with mark("radbench.run"):
                self.jobs.append(self.ext.run(self.cases)[0])
        self.counters["runs"] = len(self.jobs)
        return len(self.jobs) * len(self.job), time.perf_counter() - t0

    def answers(self):
        return [(i, r) for rows in self.jobs for i, r in zip(self.job, rows)]

    def failed(self):
        return 0

    def replay_units(self):
        return [(len(self.jobs), lambda: self.ext.run(self.cases))]

    def close(self):
        self.ext = None
"""

# (mix, its parameters, its end-to-end metric): a fixed window, the cost
# model's windows, on-off bursts into the service, and a new entry
MIXES = {
    "tiny-stream": ({"entry": "stream", "loop": "closed", "window": 3, "per_dim": 2,
                     "passes": 1}, "cases_per_s"),
    "tiny-auto": ({"entry": "stream", "loop": "closed", "window": "auto", "per_dim": 2,
                   "passes": 1}, "cases_per_s"),
    "tiny-burst": ({"entry": "service", "loop": "open", "rate_per_s": 40.0,
                    "profile": [[0.1, 2], [0.1, 0]], "tenants": 2, "per_dim": 2},
                   "latency_p95_ms"),
    "tiny-whole": ({"entry": "whole-run", "loop": "closed", "per_dim": 2, "passes": 1},
                   "cases_per_s"),
}


def snapshot(root):
    return {p: p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """A copy of the benchmark grown by new files and new entries only: a
    configuration, four mixes (one of them for a new entry, with the entry's
    driver), an end-to-end and a per-layer metric, and a cell a mix."""
    tmp = tmp_path_factory.mktemp("grown")
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "radbench", tmp / "radbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = snapshot(tmp / "radbench")

    cfg = json.loads((ROOT / "radbench/configs/kits19-shape.json").read_text())
    cfg.update(name="tiny-shape", dims=TINY_DIMS)
    (tmp / "radbench/configs/tiny-shape.json").write_text(json.dumps(cfg))
    for mix, (params, _) in MIXES.items():
        (tmp / f"radbench/traffic/{mix}.json").write_text(json.dumps(params))
    (tmp / "radbench/entries/whole-run.py").write_text(WHOLE_RUN_ENTRY)
    (tmp / "radbench/metrics/plan.cases_per_window.py").write_text(
        "def read(run):\n"
        "    plans = run.counters.get('plan')\n"
        "    return sum(p['cases'] for p in plans) / len(plans) if plans else None\n")
    (tmp / "radbench/metrics/latency_p95_ms.py").write_text(
        "from radbench import readers\n\n\n"
        "def read(run):\n"
        "    return readers.latency_ms(run, 0.95) if run.loop == 'open' else None\n")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-shape", "source": "https://arxiv.org/abs/1904.00445",
                             "file": "radbench/configs/tiny-shape.json", "reduced": [],
                             "why": "a test"})
    cells = {mix: f"tiny-shape.{mix.split('-')[1]}" for mix in MIXES}
    for mix, cell in cells.items():
        bench["workloads"].append({"name": cell, "config": "tiny-shape", "traffic": mix,
                                   "chips": 1, "why": "a test"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "cases_per_s")
    rate["workloads"] += [cells[m] for m, (_, e2e) in MIXES.items() if e2e == "cases_per_s"]
    bench["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": [cells["tiny-burst"]]})
    bench["per_layer"].append({"name": "plan.cases_per_window", "unit": "cases",
                               "better": "higher", "source": "program_counter", "layer": "plan",
                               "moves": "cases_per_s",
                               "workloads": [cells["tiny-stream"], cells["tiny-auto"]]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    yield tmp, cells
    after = snapshot(tmp / "radbench")
    assert all(after[p] == b for p, b in before.items())  # nothing that was there changed


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_new_config_traffic_entry_metric_and_cell_need_only_new_files(grown, mix):
    tmp, cells = grown
    spec = harness.Spec.load(cells[mix], tmp)
    quiet = lambda msg: None  # noqa: E731
    plain = harness.run_cell(spec, 2**31 + 5, 0.2, False, "cpu", log=quiet)
    traced = harness.run_cell(spec, 2**31 + 6, 0.2, True, "cpu", log=quiet)
    assert plain["correct"] and traced["correct"]
    assert plain["failed"] == 0 and plain["attempted"] > 0
    assert set(plain["metrics"]) == {MIXES[mix][1], "setup_s"}
    if mix == "tiny-stream":
        assert traced["metrics"]["plan.cases_per_window"]["value"] == pytest.approx(3.0, rel=0.4)
    if mix == "tiny-auto":
        assert traced["metrics"]["plan.cases_per_window"]["value"] > 0


def test_names_units_and_forms():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "radbench/metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("radbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (ROOT / "radbench/traffic" / f"{w['traffic']}.json").is_file()
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == ["radbench"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        spec = harness.Spec.load(w["name"], ROOT)
        e2e = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer
        cfg, mix = spec.config, spec.mix
        assert set(cfg["limits"])
        assert (ROOT / "radbench/entries" / f"{mix['entry']}.py").is_file()
