#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one
process, on the card:

    python3 gpubench/readings.py --workload <cell> --seeds 11 12 ... \\
        [--control 3] [--fault NAME] [--out readings.jsonl]

For each seed it makes the cell's set-up, which runs the checked steps
through the program's own call, and the shortest window (one epoch), and
prints the numbers that decide
``correct`` (the program against the reference); for the first
``--control`` seeds also the control's: the reference computed in the
nearest precision below the configuration's, put in the program's place.
With ``--fault`` the program runs with that fault planted in its timed
path (faults.py). The benchmark's own runs never run the control nor plant
a fault. One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(name: str, seeds, control: int, device, mix_overrides=None,
             emit=print, fault: str = None):
    import contextlib

    from gpubench import faults
    from gpubench.lib import spec
    from gpubench.lib.trace import Recorder
    from gpubench.run import build_config

    cell = spec.cell(spec.benchmark(), name)
    mix = {**spec.traffic(cell["traffic"]), **(mix_overrides or {})}
    cfg = build_config(spec.config(cell["config"]), mix)
    kind = spec.kind(mix["kind"])
    out = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        with (faults.planted(fault, cfg.neg_scheme == "per_slot")
              if fault else contextlib.nullcontext()):
            run = kind.Cell(cfg, mix, seed, device, Recorder())
            run.window(0.0)
        run.free()
        line = {"workload": name, "seed": seed, "fault": fault,
                "program": run.check()}
        if i < control:
            line["control"] = run.control()
        line["seconds"] = time.perf_counter() - t0
        emit(json.dumps(line))
        out.append(line)
        del run
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gpubench.lib.peaks import power_limit

    if not torch.cuda.is_available():
        print("readings.py: no CUDA card", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    emit(json.dumps({"card": power_limit()}))
    try:
        readings(args.workload, args.seeds, args.control,
                 torch.device("cuda", 0), emit=emit, fault=args.fault)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
