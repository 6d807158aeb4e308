"""The general traffic generator: a mix's parameters -> what a run sends.

A traffic mix is a data file, ``traffic/<name>.json``, whose keys this
module and the mix's entry read:

* ``entry``: the program entry the mix drives, the name of a driver file
  ``radbench/entries/<entry>.py`` (``stream``, ``service``, ``single``);
* ``per_dim``: distinct cases of each of the configuration's dimensions in
  the run's pool (built in set-up; the window replays it);
* closed loops (``loop: closed``): ``passes``, permutations of the pool in
  one job (the order the job hands the entry), ``window`` for ``stream``
  (handed to the entry as it stands: a number or ``"auto"``), and
  ``clients`` (each with its own permutation) and ``tenants`` for
  ``service``;
* open loops (``loop: open``): ``rate_per_s``, the mean offered load;
  ``profile``, optional, ``[[seconds, relative rate], ...]`` repeated
  through the window (on-off bursts: ``[[2, 3], [4, 0]]`` sends at three
  times the mean for 2 s, then nothing for 4 s), normalised to a mean of
  one; ``tenants``, taking turns.

Every seed gets the same work in another order: a job is ``passes``
permutations of the same pool, and an open loop's requests are a fixed
number whose unit-rate gaps are the exponential distribution's quantiles
at ``(i + 1/2) / n``, shuffled, then laid on the rate profile's clock.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from radbench.cases import mix_seed

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE) -> dict:
    """The parameters of the mix ``name`` (``traffic/<name>.json``)."""
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _perm(n: int, seed: int, salt: int) -> list[int]:
    g = torch.Generator().manual_seed(mix_seed(seed, salt))
    return torch.randperm(n, generator=g).tolist()


def job_order(pool_size: int, passes: int, seed: int) -> list[int]:
    """The pool indices of one closed-loop job: ``passes`` permutations."""
    return [i for p in range(passes) for i in _perm(pool_size, seed, 100 + p)]


def client_orders(pool_size: int, clients: int, seed: int) -> list[list[int]]:
    """Each closed-loop client's cases: its own permutation of the pool."""
    return [_perm(pool_size, seed, 400 + k) for k in range(clients)]


def clock(profile, mean_rate: float):
    """``at(u)``: the time by which a process of the rate profile (segments
    ``[seconds, relative rate]``, repeated, normalised to ``mean_rate``)
    has sent ``u`` requests on average: the inverse of its cumulative rate."""
    segs = [(float(d), float(r)) for d, r in (profile or [[1.0, 1.0]])]
    period = sum(d for d, _ in segs)
    norm = period / sum(d * r for d, r in segs)
    rates = [(d, mean_rate * r * norm) for d, r in segs]
    per_period = mean_rate * period

    def at(u: float) -> float:
        cycles, rest = divmod(u, per_period)
        t = cycles * period
        for d, rate in rates:
            if rate > 0 and rest <= rate * d:
                return t + rest / rate
            rest -= rate * d
            t += d
        return t
    return at


def arrivals(rate_per_s: float, seconds: float, pool_size: int, tenants: int, seed: int,
             profile=None) -> list[tuple[float, int, int]]:
    """``(due offset s, pool index, tenant)`` of an open loop's requests
    due in ``[0, seconds)``: arrivals at a mean of ``rate_per_s`` on the
    rate ``profile`` (none: Poisson at a fixed rate), unit-rate gaps the
    exponential quantiles in a seeded order; the cases cycle through
    seeded permutations of the pool; tenants take turns."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in _perm(n, seed, 200)]
    at = clock(profile, rate_per_s)
    cases = []
    p = 0
    while len(cases) < n:
        cases += _perm(pool_size, seed, 300 + p)
        p += 1
    out, u = [], 0.0
    for k in range(n):
        u += gaps[k]
        t = at(u)
        if t >= seconds:
            break
        out.append((t, cases[k], k % tenants))
    return out
