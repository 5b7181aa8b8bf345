"""One run of one cell: `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`.

Everything is found by name: the cell in BENCHMARK.json (its configuration
and traffic), portbench/workloads/<cell>.json (the entry that drives the
program and its settings), portbench/configs/<config>.json,
portbench/traffic/<mix>.json with its generator portbench/traffic/<kind>.py,
and portbench/metrics/<metric>.py. The run
builds the system from the seed, warms it up, measures the window, checks
the window's outputs against the plain reference, and prints one JSON line
as the last line of its standard output (the checks' numbers, each beside
its limit, are also the last lines of its standard error).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent      # portbench/
ROOT = BENCH.parent                                  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "chatterbox_tpu")


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """A file of the benchmark as a module (names may hold '-' or '.')."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as BENCHMARK.json and its files define it."""

    def __init__(self, name: str, bench: dict, bench_dir: Path = BENCH, **files):
        """files: config, workload or mix dicts in place of the files
        (tests)."""
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = files.get("config") or load_json(
            bench_dir / "configs" / f"{self.entry['config']}.json")
        self.workload = files.get("workload") or load_json(
            bench_dir / "workloads" / f"{name}.json")
        from .traffic import generator_path, load_mix
        self.mix = files.get("mix") or load_mix(self.entry["traffic"], bench_dir)
        self.generator = load_module(generator_path(self.mix["kind"], bench_dir),
                                     "traffic_" + self.mix["kind"])
        self.driver = load_module(bench_dir / "entries" / f"{self.workload['entry']}.py",
                                  self.workload["entry"])

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def requests(self, seed: int):
        """The mix's requests from the seed, by its kind's generator."""
        return self.generator.Requests(self.mix, seed)


def reader_path(name: str, bench_dir: Path = BENCH) -> Path:
    """portbench/metrics/<name>.py; a quantity split by the end-to-end
    metric it moves (`<quantity>.<part>`) shares metrics/<quantity>.py
    unless it has a file of its own."""
    own = bench_dir / "metrics" / f"{name}.py"
    return own if own.is_file() else bench_dir / "metrics" / f"{name.split('.')[0]}.py"


def read_metrics(specs: list, run, bench_dir: Path = BENCH) -> dict:
    """Each metric's reader (`read(run)`, see reader_path); a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in specs:
        value = load_module(reader_path(m["name"], bench_dir), m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(args.workload, bench)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    from .run_state import Run
    run = Run(cell, args, t_start)
    run.execute()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    result = run.result(read_metrics(cell.per_layer if args.trace else cell.end_to_end, run))
    print("portbench: " + json.dumps(run.notes), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
