"""Test MRRs of chip_smoke.py phase 9's ITC configuration on the CPU, through
the JAX package's CLI and the port's, at each width given (default 75 and
384): the synthetic 5,000-entity pair, 3 epochs, one evaluation. It tells a
fault at wide rows from what three epochs give at any width.

    python tests/wide_itc_reference.py [DIM ...]

Each run prints ``RESULT <package> <dim> {test MRRs} <seconds>``; the data
and outputs go under ``output/wide_itc_reference/``. It takes a few minutes.
Not collected by pytest.
"""
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(dims):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from multike_tpu import cli as jcli
    from multike_tpu_torch import cli as tcli

    chip_smoke.REPO = os.path.join(ROOT, "output", "wide_itc_reference")
    for dim in dims:
        for name, run, extra in (("jax", jcli.main, []),
                                 ("port", tcli.main, ["--device", "cpu"])):
            cfg = chip_smoke.driver_config(5000, f"{name}_{dim}", 75, 5000, 3)
            args = os.path.join(chip_smoke.REPO, f"args_{name}_{dim}.json")
            with open(args, "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
            t0 = time.time()
            mrr = run(["-m", "ITC", "-d", cfg.training_data, "--args", args,
                       "--set", f"dim={dim}"] + extra)
            print("RESULT", name, dim,
                  json.dumps({k: float(v) for k, v in mrr.items()}),
                  f"{time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main([int(x) for x in sys.argv[1:]] or [75, 384])
