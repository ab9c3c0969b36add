"""CPU tests of the harness: files found by name, the bounds against hand
counts, no result without a card, and what the benchmark imports."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from conftest import ROOT
from gpubench.lib import bounds, compare

BENCH = os.path.join(ROOT, "gpubench")
SMALL_MIX = {"entities_per_kg": 400, "triples": [1500, 1400],
             "relations": [6, 5]}


def test_a_new_cell_runs_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric, each
    added only as a file (and the cell as an entry of BENCHMARK.json) in a
    copy of the benchmark, are found by name and run."""
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    g = tmp_path / "gpubench"
    conf = json.load(open(g / "configs" / "multike-chunkshared-d75.json"))
    conf["config"]["neg_pool_size"] = 64
    (g / "configs" / "new-config.json").write_text(json.dumps(conf))
    mix = json.load(open(g / "traffic" / "dwy100k-uniform-b80k.json"))
    mix.update(SMALL_MIX, config={"batch_size": 1000})
    (g / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (g / "limits" / "new-cell.json").write_text(json.dumps(
        {"loss_gap": 1e-5, "bad_candidates": 0}))
    (g / "metrics" / "epochs_seen.new.py").write_text(
        "def read(run):\n    return run['counters']['epochs']\n")
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "epochs_seen.new", "unit": "epochs",
                               "better": "higher", "source": "host_clock",
                               "layer": "Epoch loop (train/streams.py)",
                               "moves": "rel_triples_per_s",
                               "workloads": ["new-cell"]})
    bench["end_to_end"][0]["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
        "from gpubench import run\n"
        "assert run.__file__.startswith(sys.path[0])\n"
        "for trace in (False, True):\n"
        "    r = run.run_cell('new-cell', 7, 0.01, trace, torch.device('cpu'))\n"
        "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(ln) for ln in out.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"rel_triples_per_s", "setup_s"}
    assert traced["metrics"]["epochs_seen.new"]["value"] >= 1
    assert list(traced["checks"]) == ["loss_gap", "bad_candidates"]


def test_bounds_match_hand_counts():
    d = 75
    # chunk step: 4 positives in 1 chunk, pools of 2 (4 pool rows), 10
    # unique rows. Forward: 4 distances x 4d, 4 x 4 pairs x 2d, 16
    # gathered rows (h, t, r of 4, 4 pool rows) x 3d, 4 pool norms x 2d.
    fwd = 4 * 4 * d + 16 * 2 * d + 16 * 3 * d + 4 * 2 * d
    assert bounds.chunk_step_flops(d, 4, 1, 2, 10) == 3 * fwd + 6 * d * 10
    assert fwd == 7800
    # per-slot step: 2 positives, 3 slots each, 7 unique rows. Forward:
    # 2 + 6 distances x 4d, 12 gathered rows (h, t, r of 2, 6 candidates)
    # x 3d.
    fwd = 8 * 4 * d + 12 * 3 * d
    assert bounds.per_slot_step_flops(d, 2, 3, 7) == 3 * fwd + 6 * d * 7
    # K2 at 2,000 x 8,000, d = 75; K1 over 60,000 ids, 51,891 unique
    assert bounds.k2_ops(2000, 8000, 75) == 2_400_000_000
    assert bounds.k1_bytes(60_000, 51_891, 75) == \
        60_000 * 308 + 16 * 51_891 * 75


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "rv-dwy100k-chunk-b80k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "metrics" not in out.stdout


def test_run_without_the_program_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    script = ("import sys, torch\n"
              f"sys.path[:0] = [{str(tmp_path)!r}]\n"
              "from gpubench import run\n"
              "run.run_cell('rv-dwy100k-chunk-b80k', 1, 0.01, False, "
              "torch.device('cpu'))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "multike_tpu_torch" in out.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_and_a_plain_reference():
    """By whole top-level name: ``multike_tpu_torch`` is not
    ``multike_tpu``."""
    bad = {"jax", "jaxlib", "flax", "multike_tpu"}
    for path in _sources():
        assert not set(_imports(path)) & bad, path
    for path in _sources("reference"):
        names = set(_imports(path))
        assert "multike_tpu_torch" not in names, path
        assert names <= {"__future__", "typing", "numpy", "torch",
                         "gpubench"}, path
    assert any("multike_tpu_torch" in set(_imports(p)) for p in _sources())


def test_loaded_jax_is_found_by_whole_name(monkeypatch):
    from gpubench import run

    monkeypatch.setitem(sys.modules, "multike_tpu_torch_fake",
                        types.ModuleType("multike_tpu_torch_fake"))
    assert "multike_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_judge_fails_a_number_over_its_limit_or_missing():
    ok, checks = compare.judge({"a": 1.0, "b": 0}, {"a": 1.0, "b": 0})
    assert ok and list(checks) == ["a", "b"]
    assert not compare.judge({"a": 1.5}, {"a": 1.0})[0]
    assert not compare.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not compare.judge({}, {"a": 1.0})[0]


def test_leaf_gap_leaves_out_leaves_moved_by_round_off():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.0, "b": 2.0, "c": 5e-9}
    assert compare.leaf_gap(got, ref, ref) == 0.0
    got["a"] = 1.5
    # over the larger of its own norm and the median counted leaf's (1.5)
    assert compare.leaf_gap(got, ref, ref) == pytest.approx(0.5 / 1.5)


def test_every_metric_has_its_reader():
    """Each per-layer metric, and each end-to-end one that the window does
    not give itself, has ``metrics/<name>.py``; each ``moves`` names an
    end-to-end metric that every cell of the per-layer metric reports."""
    from gpubench.lib import spec

    bench = spec.benchmark()
    by_window = {"rel_triples_per_s", "setup_s"}
    for m in bench["end_to_end"]:
        if m["name"] not in by_window:
            assert m["source"] == "device_trace", m["name"]
            assert callable(spec.metric_reader(m["name"]))
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.metrics_of(
                bench, "end_to_end", cell)}, (m["name"], cell)


def test_card_ms_per_step_is_busy_time_over_the_window_steps():
    from gpubench.lib import spec
    from gpubench.lib.trace import _merge

    read = spec.metric_reader("rel_card_ms_per_step")
    busy = _merge([(0, 4), (2, 6), (10, 11)])
    assert busy == [[0, 6], [10, 11]]
    run = {"counters": {"steps": 366}, "window_s": 51.0,
           "trace": {"busy_s": 0.732, "device_ops": 9}}
    assert read(run) == pytest.approx(2.0)
    assert read(dict(run, trace={"busy_s": 0.0, "device_ops": 0})) is None
    assert read(dict(run, counters={})) is None
