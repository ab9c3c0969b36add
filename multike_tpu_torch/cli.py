"""Command line: ``python -m multike_tpu_torch.cli -m {ITC,SSL} -d
<data-folder> [--args args.json] [--device cpu]`` (counterpart of
multike_tpu/cli.py).

Loads a reference-format JSON config (``--args``), overrides
``training_data`` and any field given with ``--set KEY=VALUE``, builds the
DataModel and the predicate-alignment model, then runs the mode's driver:
``MultiKE_ITC`` or ``MultiKE_SSL``. It runs on the card unless ``--device``
names another device; without a card it stops rather than run on the CPU.

On a mesh (``--set mesh_dp=N --set mesh_tp=M``) it runs as one process per
rank, for example ``torchrun --nproc-per-node N -m multike_tpu_torch.cli
...`` (or with the JAX package's ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID``); each rank takes ``cuda:LOCAL_RANK``
unless ``--device`` says otherwise. ``--dist-backend gloo`` lets several
ranks share one card; ``--dist-init`` names the rendezvous (for example
``file:///shared/store``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from multike_tpu_torch.config import Config, load_config
from multike_tpu_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description="MultiKE (PyTorch)")
    ap.add_argument("-m", "--mode", choices=["ITC", "SSL"], required=True)
    ap.add_argument("-d", "--training_data", type=str, required=True)
    ap.add_argument("--args", type=str, default=None,
                    help="path to a reference-format args.json")
    ap.add_argument("--max_epoch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the card)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override any Config field, e.g. --set dim=32")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend of a multi-process run "
                         "(default: nccl on the card, gloo on the CPU)")
    ap.add_argument("--dist-init", default=None, metavar="URL",
                    help="rendezvous of a multi-process run (default: "
                         "tcp://COORDINATOR_ADDRESS or MASTER_ADDR:PORT)")
    ns = ap.parse_args(argv)

    cfg = load_config(ns.args) if ns.args and os.path.exists(ns.args) \
        else Config()
    overrides = {"training_data": ns.training_data.rstrip("/") + "/"}
    if ns.max_epoch is not None:
        overrides["max_epoch"] = ns.max_epoch
    if ns.seed is not None:
        overrides["seed"] = ns.seed
    fields = {f.name for f in dataclasses.fields(Config)}
    for kv in ns.set:
        key, _, val = kv.partition("=")
        if key not in fields:
            ap.error(f"unknown config field {key!r}")
        current = getattr(cfg, key)
        if isinstance(current, bool):
            overrides[key] = val.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            overrides[key] = int(val)
        elif isinstance(current, float):
            overrides[key] = float(val)
        elif isinstance(current, list):
            overrides[key] = [int(x) for x in val.split(",")]
        else:
            overrides[key] = val
    cfg = cfg.replace(**overrides)

    # a multi-process launch joins its process group before any device work;
    # one process: a no-op
    from multike_tpu_torch.parallel import distributed

    distributed.init_distributed(backend=ns.dist_backend, device=ns.device,
                                 init_method=ns.dist_init)
    device = resolve_device(distributed.rank_device(ns.device)
                            if distributed.is_multiprocess() else ns.device)

    from multike_tpu_torch.align.predicates import PredicateAlignModel
    from multike_tpu_torch.data.dataset import DataModel

    if ns.mode == "ITC":
        from multike_tpu_torch.train.itc import MultiKE_ITC as Model
    else:
        from multike_tpu_torch.train.ssl import MultiKE_SSL as Model

    data = DataModel(cfg, verbose=True, device=device)
    pam = PredicateAlignModel(data.kgs, cfg)
    model = Model(cfg, data, pam, device=device)
    results = model.run()
    print("final test MRRs:", results)
    return results


if __name__ == "__main__":
    from multike_tpu_torch.parallel import distributed

    main()
    distributed.shutdown()
