"""The PyTorch port stands alone: importing it and every submodule loads
neither JAX, optax nor the JAX package, and no file of the port (nor
``chip_smoke.py``) imports them."""
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "multike_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|multike_tpu)(?:[.\s,]|$)"
    r"|import_module\(\s*['\"](?:jax|jaxlib|optax|multike_tpu)(?:[.'\"])",
    re.MULTILINE)

_PROBE = """
import importlib, json, pkgutil, sys
import multike_tpu_torch as m
names = [i.name for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.')]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'optax', 'multike_tpu'))
print(json.dumps([names, bad]))
"""

# every module of the ITC slice, besides those of the first slice
ITC_MODULES = {
    "multike_tpu_torch." + m for m in (
        "align.predicates", "cli", "data.cleaning", "data.dataset",
        "persistence", "text.autoencoder", "text.char_sgns",
        "text.literal_encoder", "text.word2vec", "train.itc",
        "utils.metrics", "utils.native", "views.attr_conv")}

# every module the SSL slice added
SSL_MODULES = {
    "multike_tpu_torch." + m for m in (
        "train.ssl", "train.optimizers", "utils.misc", "utils.profiling")}


# every module the multi-GPU slice added
MESH_MODULES = {
    "multike_tpu_torch." + m for m in (
        "parallel.context", "parallel.distributed", "parallel.mesh",
        "parallel.spmd", "parallel.tp_lookup", "eval.ring")}


def test_import_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) >= 40          # every submodule was imported
    assert ITC_MODULES <= set(names), ITC_MODULES - set(names)
    assert SSL_MODULES <= set(names), SSL_MODULES - set(names)
    assert MESH_MODULES <= set(names), MESH_MODULES - set(names)
    assert bad == [], bad


def _sources():
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith((".py", ".cu", ".cuh", ".h", ".cpp")):
                yield os.path.join(root, n)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    files = list(_sources())
    assert os.path.exists(files[-1])
    for path in files:
        with open(path) as f:
            text = f.read()
        m = FORBIDDEN.search(text)
        assert m is None, f"{os.path.relpath(path, REPO)}: {m.group(0)!r}"


def test_forbidden_pattern_catches_imports():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from multike_tpu.params import x")
    assert FORBIDDEN.search("import multike_tpu")
    assert FORBIDDEN.search("importlib.import_module('jax')")
    assert FORBIDDEN.search("import optax")
    assert not FORBIDDEN.search("from multike_tpu_torch.params import x")
    assert not FORBIDDEN.search("import jaxtyping_like_name_elsewhere")
