"""Finds a cell's files by the names in ``BENCHMARK.json``.

Each piece lives in a file of its own under ``gpubench/``, so a later change
adds a configuration, a traffic mix, a cell or a per-layer metric by adding
files and never edits one:

  * ``configs/<config>.json``: a configuration;
  * ``traffic/<traffic>.json``: a traffic mix, the parameters of one
    ``kind``; ``traffic/<kind>.py`` is the generator of that kind;
  * ``limits/<cell>.json``: the limits that decide a cell's ``correct``,
    by the name of each number compared (the cell's configuration and
    traffic are named in ``BENCHMARK.json`` alone);
  * ``metrics/<metric>.py``: the reader of a per-layer metric, a function
    ``read(run) -> float | None``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(RuntimeError):
    pass


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"no file {os.path.relpath(path, ROOT)}") from e


def _module(path: str, name: str):
    if not os.path.exists(path):
        raise SpecError(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return _read_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"BENCHMARK.json has no workload {name!r}")


def config(name: str) -> dict:
    return _read_json(os.path.join(BENCH_DIR, "configs", name + ".json"))


def traffic(name: str) -> dict:
    return _read_json(os.path.join(BENCH_DIR, "traffic", name + ".json"))


def limits(name: str) -> dict:
    return _read_json(os.path.join(BENCH_DIR, "limits", name + ".json"))


def kind(name: str):
    """The generator module of a traffic kind."""
    return _module(os.path.join(BENCH_DIR, "traffic", name + ".py"),
                   f"gpubench_traffic_{name}")


def metric_reader(name: str):
    """``read(run)`` of a per-layer metric (the file's name is the metric's,
    dots and all)."""
    mod = _module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                  "gpubench_metric_" + name.replace(".", "_"))
    return mod.read


def metrics_of(bench: dict, section: str, cell_name: str) -> list:
    """The entries of ``end_to_end`` or ``per_layer`` that ``cell_name``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]
