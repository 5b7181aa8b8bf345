"""Traffic: a mix is a data file, portbench/traffic/<mix>.json, whose
`kind` names the generator that reads it, portbench/traffic/<kind>.py. A
later change adds a mix of a kind that is there as a data file alone, and a
new kind as one generator file beside it.

A generator module defines `Requests(mix, seed)`:
  values      {size name: every value a request can take}, so that set-up
              can make and warm each input once;
  next()      one request's sizes as a dict, with its own `seed`, its
              `index` and `at`: the seconds after the window's opening at
              which it arrives, or None where it is sent as soon as its
              client is free (a closed loop).
Two seeds give the same set of sizes, in another order.

Shared here: `strata`, the equal-probability strata of a size distribution
that the generators draw from.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def load_mix(name: str, bench_dir: Path = ROOT) -> dict:
    """The mix file portbench/traffic/<name>.json; its kind's generator
    must be there."""
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    mix = json.loads(path.read_text())
    gen = generator_path(mix.get("kind", ""), bench_dir)
    if not gen.is_file():
        raise FileNotFoundError(f"traffic {name!r}: no generator for kind "
                                f"{mix.get('kind')!r} ({gen})")
    return mix


def generator_path(kind: str, bench_dir: Path = ROOT) -> Path:
    return bench_dir / "traffic" / f"{kind}.py"


def strata(dist: dict, n: int) -> np.ndarray:
    """The midpoints of n equal-probability strata of a size distribution."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        return lo + q * (hi - lo)
    if dist["dist"] == "loguniform":
        return np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    raise ValueError(f"unknown size distribution {dist['dist']!r}")
