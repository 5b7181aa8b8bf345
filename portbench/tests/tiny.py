"""Tiny configurations for the CPU tests: the program's own small test
widths, run through the same entries as the cells."""
from __future__ import annotations

import copy
import json
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def en_config() -> dict:
    """chatterbox-en with the program's tiny test widths for S3Gen and the
    S3 tokenizer (FlowDims / S3TokenizerConfig tiny_test)."""
    cfg = load("configs", "chatterbox-en")
    cfg["s3gen"]["flow"] = dict(enc_dim=32, enc_heads=2, enc_ff=64, enc_blocks=1,
                                enc_up_blocks=1, unet_channels=16, unet_blocks=1,
                                unet_mid=1, unet_heads=2, unet_head_dim=8)
    cfg["s3gen"]["tokenizer"] = dict(cfg["s3gen"]["tokenizer"], n_state=64, n_heads=4,
                                     n_layers=2)
    cfg["s3gen"]["hift_base_channels"] = 32
    return cfg


def vc_files() -> dict:
    wl = load("workloads", "en-vc-long")
    wl["trace_slice_s"] = 100.0        # the tiny window is traced whole
    mix = load("traffic", "vc-long-closed1")
    mix.update(block=3, target_s=[1.0, 1.2])
    mix["sizes"]["source_s"].update(lo=0.5, hi=1.0)
    return {"config": en_config(), "workload": wl, "mix": mix}


def run_cell(name: str, files: dict, seed: int = 5, seconds: float = 2.0, trace: int = 0,
             control: bool = False, bench_dict=None, bench_dir: Path = BENCH):
    """One run of a cell on the CPU at the tiny sizes: (run, result line)."""
    import time
    from portbench.harness.core import Cell, read_metrics
    from portbench.harness.run_state import Run
    b = bench_dict or bench()
    cell = Cell(name, b, bench_dir, **copy.deepcopy(files))
    args = SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    run = Run(cell, args, time.perf_counter(), device="cpu", control=control)
    run.execute()
    return run, run.result(read_metrics(cell.per_layer if trace else cell.end_to_end, run,
                                        bench_dir))
