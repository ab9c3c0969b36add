#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once, on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, data and weights from the seed, the program's objects, one
warm-up of every shape) is timed as ``setup_s``; then the window runs for
``--seconds`` and ends with the unit of work it is in. With ``--trace 1``
the window, cut to ``TRACE_WINDOW_S``, runs under ``torch.profiler`` and
the run reports the cell's per-layer metrics instead of its end-to-end
ones. Where an end-to-end metric is read from the device's clock (its
``source`` is ``device_trace``), the untraced window runs whole under a
trace of the card's activity alone, and the metric's reader,
``metrics/<name>.py``, takes it from the card's busy time. After the window
the program's state is freed and the plain reference decides ``correct``.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
``breakdown``; its last key, ``checks``, gives each number compared beside
its limit, and so do the last lines on standard error. Without a CUDA card,
with fewer cards than the cell asks for, without the program beside the
benchmark, or with ``jax``, ``jaxlib``, ``flax`` or the JAX package loaded
after the window, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "multike_tpu")
# A traced run's window, at most: the profiler's collection of a window of
# many small steps takes about twice the window, and the whole run has to
# end within 360 s.
TRACE_WINDOW_S = 15.0


def forbidden_modules():
    """Loaded modules whose top-level name is one that the port's runs must
    not load (compared whole: ``multike_tpu_torch`` is not ``multike_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_config(conf: dict, mix: dict):
    from multike_tpu_torch.config import Config

    return Config(**conf["config"]).replace(**mix.get("config", {}))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float = None, mix_overrides=None) -> dict:
    """One run of cell ``name`` on ``device``: the result's fields and
    ``checks``. ``mix_overrides`` changes the cell's traffic (tests at
    small sizes)."""
    import torch

    from gpubench.lib import compare, spec
    from gpubench.lib.trace import Recorder, device_busy, reduce_profile

    t0 = time.perf_counter() if t0 is None else t0
    bench = spec.benchmark()
    cell = spec.cell(bench, name)
    mix = {**spec.traffic(cell["traffic"]), **(mix_overrides or {})}
    cfg = build_config(spec.config(cell["config"]), mix)
    rec = Recorder(traced=trace)
    run = spec.kind(mix["kind"]).Cell(cfg, mix, seed, device, rec)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile

    end_to_end = spec.metrics_of(bench, "end_to_end", name)
    prof = undo = None
    if trace:
        ranges, undo = run.trace_hooks()
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        seconds = min(seconds, TRACE_WINDOW_S)
    elif any(m["source"] == "device_trace" for m in end_to_end):
        # An end-to-end metric read from the device's own clock: the whole
        # window runs under a trace of the card's activity alone.
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if device.type == "cuda" else
                                   ProfilerActivity.CPU])
    if prof is not None:
        prof.__enter__()
    try:
        out = run.window(seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            if undo is not None:
                undo()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    phases = {"setup_s": setup_s, "window_s": out["window_s"]}
    t1 = time.perf_counter()
    trace_out = None
    if prof is not None:
        trace_out = reduce_profile(prof, ranges) if trace else \
            device_busy(prof)
        prof = None
        phases["trace_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    run.free()
    numbers = run.check()
    phases["check_s"] = time.perf_counter() - t1
    print("run.py: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()),
          file=sys.stderr)
    correct, checks = compare.judge(numbers, spec.limits(name))

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {},
              "device": device_info}
    info = dict(spans=rec.spans, counters=rec.counters, trace=trace_out,
                window_s=out["window_s"], card=device_info["kind"])
    if trace:
        device_info["busy_s"] = trace_out["busy_s"]
        device_info["window_s"] = out["window_s"]
        for m in spec.metrics_of(bench, "per_layer", name):
            value = spec.metric_reader(m["name"])(info)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = trace_out["breakdown"]
        result["trace_coverage"] = {
            "device_op_s": trace_out["device_op_s"],
            "attributed_s": trace_out["attributed_s"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in end_to_end:
            value = values[m["name"]] if m["name"] in values else \
                spec.metric_reader(m["name"])(info)
            result["metrics"][m["name"]] = {
                "value": math.nan if value is None else value,
                "unit": m["unit"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpubench.lib import spec

    cell = spec.cell(spec.benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t0=T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"run.py: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=True))
    return 0 if all(math.isfinite(m["value"]) for m in
                    result["metrics"].values()) else 4


if __name__ == "__main__":
    sys.exit(main())
