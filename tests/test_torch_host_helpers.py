"""The port's host helpers (``csrc/host_helpers.cpp``, built at first use by
``kernels/_build.load_host``) on the CPU: the Levenshtein matrix and the
``.vec`` reader bitwise equal to their plain Python versions and to the JAX
package's functions; the package builds and loads its own library with no
``native/`` beside it; a failed build raises instead of falling back to
Python; processes that race to build share one sound library."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from multike_tpu.text import word2vec as jw2v
from multike_tpu.utils import native as jnative
from multike_tpu_torch.kernels import _build
from multike_tpu_torch.utils import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "multike_tpu_torch")

ALPHABETS = {
    "ascii": "abcdefghij klmno",
    "latin": "aeiouéèßäöüç -",
    "cjk": "日本語中文字漢한국",
    "mixed": "ab é ß 日本 z",
}


def _names(rng, alphabet, n, max_len):
    return ["".join(rng.choice(list(alphabet),
                               size=rng.randint(0, max_len + 1)))
            for _ in range(n)]


@pytest.mark.parametrize("alphabet", sorted(ALPHABETS))
def test_levenshtein_matrix_bitwise_equal(alphabet):
    rng = np.random.RandomState(sorted(ALPHABETS).index(alphabet))
    names1 = _names(rng, ALPHABETS[alphabet], 23, 12) + ["", "ab", "日本"]
    names2 = _names(rng, ALPHABETS[alphabet], 31, 12) + ["", "ba", "本日"]
    got = tnative.levenshtein_ratio_matrix(names1, names2)
    py = tnative.lev_ratio_matrix_py(names1, names2)
    assert got.dtype == np.float64 and got.shape == (26, 34)
    np.testing.assert_array_equal(got, py)
    np.testing.assert_array_equal(
        jnative.levenshtein_ratio_matrix(names1, names2), got)
    assert got[-3, -3] == 1.0                      # "" against ""
    assert got[-2, -2] == 0.5 and got[-1, -1] == 0.5


@pytest.mark.parametrize("n1,n2", [(0, 4), (3, 0), (0, 0)])
def test_levenshtein_matrix_one_side_empty(n1, n2):
    names1, names2 = ["a", "é", ""][:n1], ["x", "日本", "", "yz"][:n2]
    got = tnative.levenshtein_ratio_matrix(names1, names2)
    assert got.shape == (n1, n2) and got.dtype == np.float64
    np.testing.assert_array_equal(
        got, tnative.lev_ratio_matrix_py(names1, names2))
    np.testing.assert_array_equal(
        got, jnative.levenshtein_ratio_matrix(names1, names2))


def _vec_rows(rng, n, d):
    fmts = ("{:.4f}", "{:.6e}", "{!r}", "{:.1f}")
    return [" ".join(fmts[(i + j) % 4].format(float(np.float32(x)))
                     for j, x in enumerate(rng.randn(d)))
            for i in range(n)]


def _vec_case(name, rng, d):
    rows = _vec_rows(rng, 6, d)
    if name == "header":
        return f"5 {d}\n" + "".join(f"w{i} {r}\n" for i, r in enumerate(rows))
    if name == "short_line":
        return (f"a {rows[0]}\nshort {' '.join(rows[1].split()[:-1])}\n"
                f"b {rows[2]}\nlong {rows[3]} 1.0\n")
    if name == "duplicates":
        return "".join(f"{w} {r}\n" for w, r in zip("wvwvw", rows))
    if name == "multibyte_word":
        return f"café {rows[0]}\nstraße {rows[1]}\n日本語 {rows[2]}\n"
    if name == "empty_line":
        return f"\na {rows[0]}\n\n\nb {rows[1]}\n\n"
    if name == "no_trailing_newline":
        return f"a {rows[0]}\nb {rows[1]}"
    if name == "crlf":
        return f"a {rows[0]}\r\nb {rows[1]}\r\n"
    if name == "empty_file":
        return ""
    raise ValueError(name)


VEC_CASES = ("header", "short_line", "duplicates", "multibyte_word",
             "empty_line", "no_trailing_newline", "crlf", "empty_file")


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("case", VEC_CASES)
def test_read_word2vec_bitwise_equal(case, tmp_path):
    d = 7
    p = tmp_path / "w.vec"
    p.write_bytes(_vec_case(case, np.random.RandomState(
        VEC_CASES.index(case)), d).encode("utf-8"))
    got = tnative.read_word2vec(str(p), d)
    py = tnative.read_word2vec_py(str(p), d)
    _assert_same(got, py)
    _assert_same(jw2v.read_word2vec(str(p), d), got)
    if case == "duplicates":
        assert list(got) == ["w", "v"]
        rows = p.read_text(encoding="utf-8").splitlines()
        np.testing.assert_array_equal(
            got["w"], np.array(rows[4].split()[1:], np.float64)
            .astype(np.float32))
    if case in ("header", "multibyte_word"):
        assert len(got) == (6 if case == "header" else 3)


@pytest.mark.parametrize("text", [
    "a 1 2 \nb 3 4\n",             # a trailing space, as fastText writes
    "a  1 2\nb 3   4\n",           # runs of spaces between fields
    " a 1 2\nb 3 4\n",             # a leading space
])
def test_read_word2vec_spaces_as_jax_native(text, tmp_path):
    """Where fields are separated by more than one space, the JAX package's
    native reader and its Python one disagree; the port follows the native
    one (ROADMAP Queue 3, "Noted, not faults")."""
    p = tmp_path / "w.vec"
    p.write_text(text, encoding="utf-8")
    want = jnative.read_word2vec_native(str(p), 2)
    assert want is not None, "the JAX package's native library is not built"
    got = tnative.read_word2vec(str(p), 2)
    _assert_same(got, want)
    assert set(got) == {"a", "b"}
    assert set(tnative.read_word2vec_py(str(p), 2)) < set(got)


def test_read_word2vec_large_file_equal(tmp_path):
    rng = np.random.RandomState(5)
    d = 300
    p = tmp_path / "w.vec"
    rows = _vec_rows(rng, 400, d)
    p.write_text(f"400 {d}\n" + "".join(
        f"w{i % 350}é {r}\n" for i, r in enumerate(rows)), encoding="utf-8")
    got = tnative.read_word2vec(str(p), d)
    assert len(got) == 350
    _assert_same(got, tnative.read_word2vec_py(str(p), d))


def test_read_word2vec_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnative.read_word2vec(str(tmp_path / "absent.vec"), 4)


@pytest.fixture
def empty_build(tmp_path, monkeypatch):
    """``_build`` with an empty build directory and no library loaded."""
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_build, "_host_lib", None)
    return build_dir


def _calls(tmp_path):
    p = tmp_path / "w.vec"
    p.write_text("a 1 2\n", encoding="utf-8")
    return (lambda: tnative.levenshtein_ratio_matrix(["ab"], ["ba"]),
            lambda: tnative.read_word2vec(str(p), 2))


def test_no_python_fallback_without_a_compiler(tmp_path, monkeypatch,
                                               empty_build):
    missing = str(tmp_path / "no-such-c++")
    monkeypatch.setattr(_build, "_cxx", lambda: missing)
    for call in _calls(tmp_path):
        with pytest.raises(RuntimeError, match="no-such-c"):
            call()
    assert os.listdir(empty_build) == []        # no temporary dir left


def test_no_python_fallback_when_the_compile_fails(tmp_path, monkeypatch,
                                                    empty_build):
    cxx = tmp_path / "failing-c++"
    cxx.write_text("#!/bin/sh\necho 'host_helpers.cpp:1: error: broken'\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(_build, "_cxx", lambda: str(cxx))
    for call in _calls(tmp_path):
        with pytest.raises(RuntimeError, match="error: broken"):
            call()
    assert os.listdir(empty_build) == []        # no temporary dir left


def test_missing_compiler_on_path_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="c\\+\\+ or g\\+\\+"):
        _build._cxx()


_PROBE = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
opened = []
def hook(event, args):
    if event in ("open", "ctypes.dlopen") and args and args[0] is not None:
        opened.append(os.fsdecode(args[0]) if isinstance(
            args[0], (str, bytes)) else str(args[0]))
sys.addaudithook(hook)
import multike_tpu_torch
from multike_tpu_torch.kernels import _build
from multike_tpu_torch.utils import native
m = native.levenshtein_ratio_matrix(["straße", "日本", ""], ["strasse", ""])
path = sys.argv[2]
with open(path, "w", encoding="utf-8") as f:
    f.write("2 3\nfoo 1 2 3\nbär 0.5 -1 1e-3\n")
w = native.read_word2vec(path, 3)
with open("/proc/self/maps") as f:
    mapped = sorted({ln.split()[-1] for ln in f
                     if ln.rstrip().endswith(".so")})
print(json.dumps(dict(
    pkg=multike_tpu_torch.__file__, lib=_build.load_host()._name,
    matrix=m.tolist(), words={k: v.tolist() for k, v in w.items()},
    opened=opened, mapped=mapped,
    jax=sorted(k for k in sys.modules
               if k.split(".")[0] in ("jax", "multike_tpu")))))
"""


def test_copied_package_builds_its_own_helpers(tmp_path):
    """The package alone, with no ``native/`` beside it, builds and loads
    its own library and opens nothing of the JAX package's."""
    copy = tmp_path / "copy"
    shutil.copytree(PKG, copy / "multike_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    assert not (copy / "native").exists()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(copy), str(tmp_path / "w.vec")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    r = json.loads(out.stdout.strip().splitlines()[-1])
    build = str(copy / "multike_tpu_torch" / "build") + os.sep
    assert r["pkg"].startswith(str(copy) + os.sep)
    assert r["lib"].startswith(build)
    assert r["lib"] in r["mapped"]
    assert [p for p in r["opened"] if p.endswith(".so")
            and "multike" in os.path.basename(p)] == [r["lib"]]
    assert not [p for p in r["opened"] + r["mapped"]
                if "libmultike_native" in p]
    assert r["jax"] == []
    np.testing.assert_array_equal(
        r["matrix"], tnative.lev_ratio_matrix_py(["straße", "日本", ""],
                                                 ["strasse", ""]))
    assert r["words"] == {"foo": [1.0, 2.0, 3.0],
                          "bär": [0.5, -1.0, float(np.float32(1e-3))]}


_RACE = r"""
import sys
sys.path.insert(0, sys.argv[1])
from multike_tpu_torch.kernels import _build
_build.BUILD_DIR = sys.argv[2]
from multike_tpu_torch.utils import native
m = native.levenshtein_ratio_matrix(["kitten"], ["sitting"])
print(_build.load_host()._name, repr(float(m[0, 0])))
"""


def test_racing_builds_share_one_library(tmp_path):
    """Processes that build into one empty directory at once all load the
    same library, and leave no temporary directory behind."""
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE, REPO, str(build_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(out.split())
    want = repr(float(
        tnative.lev_ratio_matrix_py(["kitten"], ["sitting"])[0, 0]))
    assert {o[0] for o in outs} == {_build.host_library_path().replace(
        _build.BUILD_DIR, str(build_dir))}
    assert [o[1] for o in outs] == [want] * 3
    assert os.listdir(build_dir) == [os.path.basename(outs[0][0])]
