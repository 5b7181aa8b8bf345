"""CPU tests of the port's benchmark: that it is driven by its files, that
its traffic, counts and result line are what they claim, that its
reference agrees with the program's plain CPU path at tiny sizes, that a
broken program fails its check, and that nothing it runs imports JAX or
the JAX package. Run from the repository's root:

    python -m pytest portbench/tests -q

The test that needs the card (`test_controls_fail_on_the_card`) is marked
`cuda` and skips without one."""
from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import core, traffic, weights
from portbench.harness.trace import TraceSummary
from portbench.roofline import model
from portbench.tests import tiny

BENCH = tiny.BENCH
ROOT = tiny.ROOT


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------

def test_every_file_loads_by_name():
    b = tiny.bench()
    for w in b["workloads"]:
        cell = core.Cell(w["name"], b)
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.driver, "setup") and hasattr(cell.driver, "check")
        assert cell.end_to_end and cell.per_layer
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    names = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(core.load_module(core.reader_path(m["name"]), m["name"]).read)
        assert m.get("moves", m["name"]) in names
    for w in b["workloads"]:
        reported = {m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        for m in b["per_layer"]:
            if w["name"] in m["workloads"]:
                assert m["moves"] in reported


FIXED_RATE = '''"""A test kind: requests of fixed sizes at a fixed rate (open loop)."""
import numpy as np


class Requests:
    def __init__(self, mix, seed):
        self.mix = mix
        self.values = {k: np.asarray(v, float) for k, v in mix["values"].items()}
        self.rng = np.random.default_rng([int(seed), 7])
        self.index = 0

    def next(self):
        req = {k: float(self.rng.choice(v)) for k, v in self.values.items()}
        req.update(seed=int(self.rng.integers(1, 2**62)), index=self.index,
                   at=self.index / self.mix["rate_per_s"])
        self.index += 1
        return req
'''


def test_a_cell_a_mix_kind_and_a_metric_added_as_files_are_picked_up(tmp_path):
    """A later change adds a cell (a workload file, a traffic mix of a kind
    no generator made before, that kind's generator, a BENCHMARK.json
    entry) and a per-layer metric (a reader file and an entry), editing no
    file that is there; the new cell runs through the entry that is there."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return len(run.in_window())\n")
    (bench_dir / "traffic" / "fixed_rate.py").write_text(FIXED_RATE)
    mix = {"kind": "fixed_rate", "rate_per_s": 4.0, "values": {"source_s": [0.5, 0.7]},
           "target_s": [1.0], "target_f0": [150.0]}
    (bench_dir / "traffic" / "vc-open4.json").write_text(json.dumps(mix))
    shutil.copy(BENCH / "workloads" / "en-vc-long.json",
                bench_dir / "workloads" / "en-vc-open4.json")
    b = tiny.bench()
    b["workloads"].append({"name": "en-vc-open4", "config": "chatterbox-en",
                           "traffic": "vc-open4", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                           "source": "host_clock", "layer": "pipelines", "moves":
                           "audio_s_per_s.vc", "workloads": ["en-vc-open4"]})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("en-vc-open4")
    cell = core.Cell("en-vc-open4", b, bench_dir)
    assert cell.mix["kind"] == "fixed_rate"
    assert [m["name"] for m in cell.per_layer][-1] == "requests_done"
    assert "requests_done" not in [m["name"] for m in core.Cell("en-vc-long", b,
                                                                 bench_dir).per_layer]
    reqs = cell.requests(3)
    assert [reqs.next()["at"] for _ in range(3)] == [0.0, 0.25, 0.5]

    files = tiny.vc_files()
    files["mix"] = mix
    run, res = tiny.run_cell("en-vc-open4", files, seconds=1.5, trace=1, bench_dict=b,
                             bench_dir=bench_dir)
    assert res["correct"] is True
    done = run.in_window()
    assert res["metrics"]["requests_done"] == {"value": float(len(done)), "unit": "requests"}
    # each request's latency counts from its arrival, not from its sending
    for r in run.requests:
        assert r.submit_t == pytest.approx(run.t_open + r.index / 4.0)


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["en-vc-long"])
def test_traffic_is_a_function_of_the_seed(cell):
    c = core.Cell(cell, tiny.bench())
    m = c.mix
    draw = lambda seed, n: _take(c.requests(seed), n)
    a, b, c = draw(2**31 + 11, 48), draw(2**31 + 11, 48), draw(7, 48)
    assert a == b
    assert a != c
    key = next(iter(m["sizes"]))
    block = m["block"]
    for i in range(0, 48 - block + 1, block):
        # every seed gets the same set of sizes in each block, in another order
        assert sorted(r[key] for r in a[i:i + block]) == sorted(r[key] for r in c[i:i + block])


def _take(gen, n):
    return [gen.next() for _ in range(n)]


def test_strata_cover_the_distribution():
    s = traffic.strata({"dist": "loguniform", "lo": 3.0, "hi": 20.0}, 16)
    assert 3.0 < s[0] < s[-1] < 20.0
    assert np.allclose(np.diff(np.log(s)), np.log(20 / 3) / 16)
    u = traffic.strata({"dist": "uniform", "lo": 20.0, "hi": 40.0}, 8)
    assert np.allclose(u, 20 + 2.5 * (np.arange(8) + 0.5))


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

def test_s3gen_flops_fit_the_counted_points():
    cfg = tiny.en_config()
    key = json.dumps(cfg, sort_keys=True)
    for P, G in ((6, 20), (9, 300)):
        want = model._flow_flops(key, P + G) + model._hift_flops(key, G)
        assert math.isclose(model.s3gen_vocode_flops(cfg, P, G), want, rel_tol=1e-9)
    assert math.isclose(model.s3_tokenizer_flops(cfg, 100),
                        model._tokenizer_flops(key, 100), rel_tol=1e-9)


def test_tokenizer_flops_by_hand():
    """The S3 tokenizer's encoder over N tokens (4N mel frames): two
    stride-2 convolutions of width 3, then per layer q / k / v / out (4
    d x d), the MLP (d x 4d twice) and attention's scores and weighted sum
    (2 N^2 d each), then FSQ's projection; each product 2 FLOPs a
    multiply-add."""
    cfg = tiny.en_config()
    t = cfg["s3gen"]["tokenizer"]
    d, M, L, F = t["n_state"], t["n_mels"], t["n_layers"], t["fsq_dim"]
    for N in (50, 300):
        want = (2 * (2 * N) * d * M * 3 + 2 * N * d * d * 3
                + L * (2 * N * (4 * d * d + 8 * d * d) + 4 * N * N * d) + 2 * N * d * F)
        assert math.isclose(model.s3_tokenizer_flops(cfg, N), want, rel_tol=1e-9), N


def test_trace_reduction_by_hand():
    class E:
        def __init__(self, name, dev, s, e, corr=0):
            self._n, self._d, self._s, self._e, self._c = name, dev, s, e, corr

        def name(self): return self._n
        def device_type(self): return self._d
        def start_ns(self): return self._s
        def end_ns(self): return self._e
        def duration_ns(self): return self._e - self._s
        def correlation_id(self): return self._c

    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [E("pb:watermark", CPU, 0, 100), E("pb:s3gen.dispatch", CPU, 100, 200),
          E("cudaLaunchKernel", CPU, 10, 11, 1), E("cudaLaunchKernel", CPU, 150, 151, 2),
          E("k_wm", CUDA, 20, 40, 1), E("k_voc", CUDA, 160, 200, 2),
          E("k_voc", CUDA, 190, 230, 2)]
    s = TraceSummary(ev, 1e-6)
    assert s.busy_s == pytest.approx((20 + 70) / 1e9)
    assert s.device_s(lambda n, l: l.startswith("s3gen")) == pytest.approx(80 / 1e9)
    assert s.device_s(lambda n, l: l == "watermark") == pytest.approx(20 / 1e9)
    assert dict(s.gaps) == {"s3gen.dispatch": pytest.approx(120 / 1e9)}
    assert s.breakdown()["device_ops"][0] == ["k_voc", pytest.approx(80 / 1e9)]


def test_bulk_weights_are_a_function_of_the_seed():
    from portbench.reference import s3gen as ref_s3
    cfg = tiny.en_config()
    a, b, c = (weights.make_tree(ref_s3.s3gen_init, cfg, seed, "cpu", torch.float32)
               for seed in (3, 3, 4))
    pick = lambda t: t["flow"]["input_embedding"]["w"]
    wa, wb, wc = pick(a), pick(b), pick(c)
    assert wa.dtype == torch.float32 and torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert torch.equal(a["flow"]["spk_embed_affine"]["w"], b["flow"]["spk_embed_affine"]["w"])


# ---------------------------------------------------------------------------
# the reference against the program's plain CPU path
# ---------------------------------------------------------------------------

def test_s3gen_reference_matches_the_program():
    from portbench.harness import inputs, program
    from portbench.reference import s3gen as ref_s3
    cfg = tiny.en_config()
    tree = weights.make_tree(ref_s3.s3gen_init, cfg, 5, "cpu", torch.float32)
    eng = program.s3gen_engine(cfg, tree)
    wav24 = inputs.synthetic_voice(1.2, 24000, 3)
    src16 = inputs.synthetic_voice(0.8, 16000, 4)
    voice = eng.embed_ref(wav24, 24000)
    rv, _ = ref_s3.embed_ref(tree, cfg, torch.from_numpy(wav24), 24000)
    P = int(voice.prompt_token_len[0])
    assert torch.equal(rv.prompt_token, torch.from_numpy(voice.prompt_token[0, :P]).long())
    torch.testing.assert_close(rv.prompt_feat, torch.from_numpy(voice.prompt_feat))
    torch.testing.assert_close(rv.embedding, torch.from_numpy(voice.embedding))
    tok, _ = eng.tokenize(src16)
    rt, margin = ref_s3.tokenize(tree, cfg, torch.from_numpy(src16))
    assert torch.equal(rt, torch.from_numpy(tok[0]).long()) and float(margin.min()) >= 0
    wav = eng.inference(tok[0], voice, generator=torch.Generator().manual_seed(11))
    rw = ref_s3.vocode(tree, cfg, rv, rt, torch.Generator().manual_seed(11))
    torch.testing.assert_close(rw, torch.from_numpy(wav[0]), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# whole runs on the CPU at tiny sizes: the result line, a broken program
# ---------------------------------------------------------------------------

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_result_line():
    run, res = tiny.run_cell("en-vc-long", tiny.vc_files(), seconds=2.0)
    assert list(res) == RESULT_KEYS
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"audio_s_per_s.vc", "setup_s"}
    assert res["metrics"]["audio_s_per_s.vc"]["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


def test_traced_result_line():
    run, res = tiny.run_cell("en-vc-long", tiny.vc_files(), seconds=3.0, trace=1)
    assert list(res) == RESULT_KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"] is True
    # on the CPU the trace holds no device operation, so the device-time
    # readers find nothing and their metrics are left out
    assert "mfu_pct.vc" in res["metrics"]
    assert set(res["metrics"]) <= {m["name"] for m in run.cell.per_layer}
    assert 0 < res["metrics"]["mfu_pct.vc"]["value"]


def _break(monkeypatch, what):
    """Faults of the timed path, planted underneath the harness: a token or
    an answer altered where it is produced."""
    from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine
    if what == "token":
        real = S3GenEngine.tokenize

        def tok(self, wav, max_len=None):
            t, n = real(self, wav, max_len)
            t = t.copy()
            t[0, len(t[0]) // 2] = (t[0, len(t[0]) // 2] + 1) % 6561
            return t, n
        monkeypatch.setattr(S3GenEngine, "tokenize", tok)
    elif what == "voice":
        real = S3GenEngine.embed_ref

        def emb(self, *a, **kw):
            v = real(self, *a, **kw)
            return v._replace(embedding=v.embedding * 1.01)
        monkeypatch.setattr(S3GenEngine, "embed_ref", emb)
    elif what == "audio":
        from chatterbox_tpu_torch.api.pipelines import ChatterboxVC
        real = ChatterboxVC.generate
        monkeypatch.setattr(ChatterboxVC, "generate",
                            lambda self, *a, **kw: real(self, *a, **kw) * 1.05)


@pytest.mark.parametrize("fault,number", [("token", "tok_mismatch"),
                                          ("voice", "voice_rel_err"),
                                          ("audio", "wav_rel_err")])
def test_a_broken_program_is_not_correct(monkeypatch, fault, number):
    _break(monkeypatch, fault)
    _, res = tiny.run_cell("en-vc-long", tiny.vc_files(), seconds=2.0)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["en-vc-long"])
def test_controls_fail_on_the_card(cell):
    """The cell's control at the cell's own size, on three seeds: the
    reference in lower precision (TF32) in the program's place comes out
    not correct (a short window long enough to finish the mix's longest
    requests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls run at the cell's own size")
    import time
    from types import SimpleNamespace
    from portbench.harness.core import Cell
    from portbench.harness.run_state import Run
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        run = Run(Cell(cell, tiny.bench()), SimpleNamespace(seed=seed, seconds=15, trace=0),
                  time.perf_counter(), control=True)
        run.execute()
        print(f"control {cell} seed {seed}: {run.checks}")
        assert any(c["value"] > c["limit"] for c in run.checks.values()), run.checks


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "chatterbox_tpu"}


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "numpy", "torch", "typing", "dataclasses",
                        "functools", "contextlib", "hashlib", "logging"}, (path, tops)


def test_a_run_loads_no_jax_module():
    """What the harness, the reference and the program load in one process,
    compared by whole top-level names."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests import tiny\n"
            "tiny.run_cell('en-vc-long', tiny.vc_files(), seconds=1.0)\n"
            "from portbench.harness.core import forbidden_modules\n"
            "print(forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_benchmark_refuses_without_a_card(tmp_path):
    """Without a CUDA device (or in a checkout that holds only the
    benchmark) a run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "en-vc-long", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
    only = tmp_path / "checkout"
    shutil.copytree(BENCH, only / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", only)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "en-vc-long",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=only)
    assert out.returncode != 0 and out.stdout.strip() == ""
