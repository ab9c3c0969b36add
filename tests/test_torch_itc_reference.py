"""The port's seven ITC streams against the benchmark's plain float64
reference (``gpubench/reference/multike.py``) on the CPU, and that
reference's CNN scorer against the JAX package's.

* Each stream, built as the trainer builds it (``streams.build_*_epoch``),
  takes three steps from tables made by ``gpubench/lib/itc_data.py`` at 300
  entities a KG and the published width 75, on the row-sparse and the
  dense branch; the reference follows the same batches in float64. Each
  step's loss agrees within 1e-5 (relative): the program sums a few hundred
  float32 terms a step, a relative error of a few 1e-7 (read: at most
  1.2e-7). Each parameter's change agrees within 1e-5 of the stream's
  largest change element, for the float32 rounding of the gradients (read:
  about 1e-6 of it), plus half an ulp of the parameter a step: the program
  stores each step's new value in float32, which rounds it by up to 2**-24
  of its magnitude, and a change of 1e-5 on a parameter near 1 (batch
  norm's gamma) keeps only a few digits.
* The CNN scorer with its SAME padding flipped (the extra row and column
  before, not after) fails both bounds.
* The reference's scorer, written from the published TF1 model with its
  own convolution, scores as ``multike_tpu/views/attr_conv.py`` does
  (float32, JAX on the CPU), within 1e-5 of the largest score, with masked
  rows; a one-hot image shows the padding's extra column after the row.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpubench.lib import itc_data
from gpubench.reference import multike
from multike_tpu.views.attr_conv import conv_stages as jconv_stages
from multike_tpu_torch.config import Config
from multike_tpu_torch.sampling import build_neighbor_state
from multike_tpu_torch.train import sparse_adagrad
from multike_tpu_torch.train import streams as tst
from multike_tpu_torch.views import attr_conv

N, R, A, V, D = 300, (6, 5), (7, 9), 400, 75
E = 2 * N
RANGES = ((0, N), (N, E))
CFG = dict(dim=D, batch_size=240, entity_batch_size=120,
           attribute_batch_size=240, truncated_chunk_size=64,
           truncated_pool_size=16)
STEPS = 3
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5


def _rows(rng, n, ents, rels, tails):
    return np.stack([rng.randint(*ents, n), rng.randint(*rels, n),
                     rng.randint(*tails, n)], 1)


def _batches(stream, cfg, rng):
    """(epoch, each step's inputs after params and opt_state, the
    reference's batch of each step)."""
    def w(n):
        return torch.as_tensor(0.2 + 0.8 * rng.rand(n), dtype=torch.float32)

    rel = (0, sum(R))
    attr = (0, sum(A))
    if stream == "rel_view":
        t1 = torch.as_tensor(_rows(rng, 700, (0, N), (0, R[0]), (0, N)))
        t2 = torch.as_tensor(_rows(rng, 650, (N, E), (R[0], sum(R)), (N, E)))
        epoch, _, _ = tst.build_rel_view_epoch(cfg, len(t1), len(t2), RANGES,
                                               with_neighbors=True)
        nbr = build_neighbor_state(E, [
            (np.arange(lo, hi), rng.randint(lo, hi, (hi - lo, 6)))
            for lo, hi in RANGES])
        xs = epoch.draw(torch.Generator().manual_seed(3), t1, t2, nbr)
        inputs = [tuple(x[i] for x in xs) for i in range(STEPS)]
        keys = ("pos", "mask", "ch", "ct")
        refs = [[dict(zip(keys, b[:4])), dict(zip(keys, b[4:]))]
                for b in inputs]
        return epoch, inputs, refs
    if stream == "attr_view":
        epoch, _, _ = tst.build_attr_view_epoch(cfg, 500, 600)
        t1 = torch.as_tensor(_rows(rng, 500, (0, N), (0, A[0]), (0, V)))
        t2 = torch.as_tensor(_rows(rng, 600, (N, E), (A[0], sum(A)), (0, V)))
        xs = epoch.draw(torch.Generator().manual_seed(4), t1, w(500), t2,
                        w(600))
        inputs = [tuple(x[i] for x in xs) for i in range(STEPS)]
        return epoch, inputs, [dict(pos=t, w=wt, mask=m)
                               for t, wt, m in inputs]
    n = 120 if stream == "common_space" else 240
    epoch, _, _ = getattr(tst, f"build_{stream}_epoch")(cfg, 4 * n)
    inputs, refs = [], []
    for _ in range(STEPS):
        if stream == "common_space":
            b = (torch.as_tensor(rng.permutation(E)[:n]),)
            ref = dict(ents=b[0])
        else:
            pos = torch.as_tensor(
                _rows(rng, n, (0, E), rel, (0, E)) if stream.endswith("rel")
                else _rows(rng, n, (0, E), attr, (0, V)))
            b = (pos, w(n)) if stream.startswith("ckg") and \
                stream[3] in "pa" else (pos,)
            ref = dict(zip(("pos", "w"), b))
        inputs.append(b)
        refs.append(ref)
    return epoch, inputs, refs


def _delta_gaps(stream, sparse):
    """The port's and the reference's per-step losses, and the largest
    ratio of a parameter's change gap to its bound (see the module's
    docstring; at most 1 passes)."""
    cfg = Config(row_sparse_updates=sparse, **CFG)
    rng = np.random.RandomState(1)
    tables = itc_data.tables(1, E, sum(R), sum(A), D, "cpu")
    names, literals = itc_data.vectors(1, E, V, D)
    consts = {"name_embeds": torch.as_tensor(names),
              "literal_embeds": torch.as_tensor(literals)}
    params = {k: ({n: t.clone() for n, t in v.items()}
                  if isinstance(v, dict) else v.clone())
              for k, v in tables.items()}
    opt = {k: sparse_adagrad.init_acc(params[k])
           for k in tst.STREAM_VARS[stream]}
    epoch, inputs, refs = _batches(stream, cfg, rng)
    lead = (consts,) if stream in ("attr_view", "ckge_attr", "ckga_attr",
                                   "common_space") else ()
    losses = [float(epoch.step(params, opt, *lead, *b)) for b in inputs]
    rates = {s: cfg.learning_rate for s in multike.STREAMS}
    rates["common_space"] = cfg.ITC_learning_rate
    f = multike.Follower(tables, consts, rates, cfg.neg_triple_num,
                         cfg.cv_weight, cfg.cv_name_weight)
    ref_losses = [f.step(stream, b)[0] for b in refs]
    mine = multike.flat({t: params[t] for t in multike.STREAMS[stream]})
    theirs = multike.flat({t: f.p[t] for t in multike.STREAMS[stream]})
    initial = multike.flat(tables)
    changes = {k: theirs[k] - initial[k].double() for k in mine}
    largest = max(float(c.abs().max()) for c in changes.values())
    ratio = max(float(((mine[k].double() - theirs[k]).abs()
                       / (GRAD_TOL * largest
                          + STEPS * 2.0 ** -24 * theirs[k].abs())).max())
                for k in mine)
    return losses, ref_losses, ratio


@pytest.mark.parametrize("stream", list(multike.STREAMS))
@pytest.mark.parametrize("sparse", ["on", "off"])
def test_stream_follows_the_float64_reference(stream, sparse):
    losses, ref_losses, ratio = _delta_gaps(stream, sparse)
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("stream", ["attr_view", "ckge_attr", "ckga_attr"])
def test_flipped_same_padding_fails(stream, monkeypatch):
    monkeypatch.setattr(attr_conv, "SAME_PAD", (2, 1, 1, 0))
    losses, ref_losses, ratio = _delta_gaps(stream, "on")
    assert max(abs(a - b) / abs(b) for a, b in
               zip(losses, ref_losses)) > 10 * LOSS_RTOL
    assert ratio > 10.0


def test_reference_scorer_matches_the_jax_package():
    rng = np.random.RandomState(5)
    b = 37
    conv = itc_data.conv_tables(torch.Generator().manual_seed(5), D, "cpu")
    conv["bn_gamma"] = torch.as_tensor(1 + 0.1 * rng.randn(D),
                                       dtype=torch.float32)
    conv["bn_beta"] = torch.as_tensor(0.1 * rng.randn(D), dtype=torch.float32)
    for i in range(2):
        conv[f"conv{i}_b"] = torch.as_tensor(0.1 * rng.randn(2),
                                             dtype=torch.float32)
    conv["dense_b"] = torch.as_tensor(0.1 * rng.randn(D), dtype=torch.float32)
    hs, as_, vs = (rng.randn(b, D).astype(np.float32) for _ in range(3))
    mask = (np.arange(b) < 30).astype(np.float32)
    want = jconv_stages({k: jnp.asarray(v.numpy()) for k, v in conv.items()},
                        jnp.asarray(hs), jnp.asarray(as_), jnp.asarray(vs),
                        mask=jnp.asarray(mask))
    score = multike.conv_score({k: v.double() for k, v in conv.items()},
                               *(torch.as_tensor(x, dtype=torch.float64)
                                 for x in (hs, as_, vs)),
                               torch.as_tensor(mask, dtype=torch.float64))
    got, wanted = score.numpy(), np.asarray(want["score"])
    assert np.abs(got - wanted).max() <= 1e-5 * np.abs(wanted).max()
    # the padding: an image whose only nonzero value sits in the last
    # column of the first row reaches the output only through the extra
    # column after it
    x = torch.zeros(1, 2, D, 1, dtype=torch.float64)
    x[0, 0, D - 1, 0] = 1.0
    w = torch.zeros(2, 4, 1, 1, dtype=torch.float64)
    w[0, 0, 0, 0] = 1.0                 # the kernel's first column
    out = multike.conv_same(x, w, torch.zeros(1, dtype=torch.float64))
    assert out[0, 0, D - 1, 0] == 0.0 and out[0, 0, D - 2, 0] == 0.0
    w[0, 0, 0, 0], w[0, 1, 0, 0] = 0.0, 1.0      # the second: left pad 1
    out = multike.conv_same(x, w, torch.zeros(1, dtype=torch.float64))
    assert out[0, 0, D - 1, 0] == 1.0
