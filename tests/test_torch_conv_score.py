"""The CNN scorer's closed-form backward (``kernels/conv_score.py``'s plain
version, which the streams' ``conv_score`` runs on the CPU inside the
scorer's autograd ``Function``) against autograd through ``conv_stages``
and ``positive_logistic_from_scores``: in float64 within 1e-10, in float32
within 5e-6 of each gradient's largest element (float32 sums in another
order: the convolution as taps, the whole-batch norm's two terms apart).
Also a batch split over two ranks, whose ``batch_sum`` sums the parts'
scalars, against the whole batch, and the weight gradient's split."""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from multike_tpu_torch import params as tp
from multike_tpu_torch.kernels import conv_score as k4
from multike_tpu_torch.losses import positive_logistic_from_scores
from multike_tpu_torch.views import attr_conv

B = 24
CASES = [(8, False, False), (8, True, False), (8, False, True),
         (8, True, True), (75, False, False), (75, True, False),
         (75, False, True), (75, True, True)]


def _inputs(d, masked, weighted, all_masked=False, seed=0):
    """A scorer with a non-trivial batch norm and biases, unit head rows,
    attribute and value rows, and the masks and weights, as numpy."""
    rng = np.random.RandomState(seed + d)
    gen = torch.Generator().manual_seed(seed)
    conv = {k: v.numpy() for k, v in
            tp.init_conv_params(gen, d, "cpu").items()}
    conv["bn_gamma"] = 1 + 0.3 * rng.normal(size=d)
    conv["bn_beta"] = 0.1 * rng.normal(size=d)
    for k in ("conv0_b", "conv1_b", "dense_b"):
        conv[k] = 0.1 * rng.normal(size=conv[k].shape)
    h, a, v = (rng.normal(size=(B, d)) for _ in range(3))
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    mask = None
    if all_masked:
        mask = np.zeros(B)
    elif masked:
        mask = (np.arange(B) < B - 5).astype(np.float64)
    w = rng.uniform(0.2, 1.0, size=B) if weighted or all_masked else None
    return conv, (h, a, v), mask, w


def _tensors(conv, rows, mask, w, dtype):
    to = lambda x: None if x is None else torch.tensor(x, dtype=dtype)  # noqa
    p = {k: to(x).requires_grad_() for k, x in conv.items()}
    return p, [to(x).requires_grad_() for x in rows], to(mask), to(w)


def _grads(score_fn, p, rows, mask, w, loss_mask):
    """The scores and the gradients of the weighted logistic loss over
    them with respect to the rows and every parameter."""
    score = score_fn(p, *rows, mask=mask)
    loss = positive_logistic_from_scores(score, weights=w, mask=loss_mask)
    leaves = list(rows) + list(p.values())
    return score.detach(), torch.autograd.grad(loss, leaves)


def _stages_score(p, h, a, v, mask=None, batch_sum=None):
    return attr_conv.conv_stages(p, h, a, v, mask=mask,
                                 batch_sum=batch_sum)["score"]


def _assert_near(got, want, rel):
    for g, x in zip(got, want):
        assert g.shape == x.shape
        top = float(x.abs().max())
        assert float((g - x).abs().max()) <= rel * max(top, 1e-30), (
            float((g - x).abs().max()), top)


def _case(d, masked, weighted, all_masked, dtype, rel):
    conv, rows, mask, w = _inputs(d, masked, weighted, all_masked)
    # the all-masked batch keeps its loss unmasked, so that the gradients
    # of the head rows are not all zero
    p, r, m, wt = _tensors(conv, rows, mask, w, dtype)
    loss_mask = None if all_masked else m
    want_s, want = _grads(_stages_score, p, r, m, wt, loss_mask)
    p, r, m, wt = _tensors(conv, rows, mask, w, dtype)
    score = attr_conv.conv_score(p, *r, mask=m)
    assert type(score.grad_fn).__name__ == "_ConvScoreBackward"
    got_s, got = _grads(attr_conv.conv_score, p, r, m, wt, loss_mask)
    _assert_near([got_s], [want_s], rel)
    _assert_near(got, want, rel)
    return got


@pytest.mark.parametrize("d,masked,weighted", CASES)
def test_closed_form_gradients_match_autograd(d, masked, weighted):
    _case(d, masked, weighted, False, torch.float64, 1e-10)
    _case(d, masked, weighted, False, torch.float32, 5e-6)


@pytest.mark.parametrize("d", [8, 75])
def test_all_masked_batch_takes_the_clamp(d):
    """Every row masked: ``S`` = 0 < EPS_L2, so the whole-batch norm is
    the clamp's and passes no gradient; the scorer's parameters and the
    attribute rows get none, the head rows theirs."""
    for dtype, rel in ((torch.float64, 1e-10), (torch.float32, 5e-6)):
        got = _case(d, False, True, True, dtype, rel)
        assert float(got[0].abs().max()) > 0
        assert all(float(g.abs().max()) == 0 for g in got[1:])


class _TwoRanks:
    """``batch_sum`` of two threads standing in for two dp ranks: each
    deposits its scalar, and both get rank 0's plus rank 1's."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=60)
        self.vals = [None, None]

    def batch_sum(self, rank):
        def f(x):
            self.vals[rank] = x
            self.barrier.wait()
            out = self.vals[0] + self.vals[1]
            self.barrier.wait()
            return out
        return f


@pytest.mark.parametrize("d,masked,weighted,all_masked", [
    case + (False,) for case in CASES] + [(8, False, True, True),
                                          (75, False, True, True)])
def test_split_batch_gives_the_whole_batch(d, masked, weighted, all_masked):
    """The batch cut in two parts (10 and 14 rows), each scored with a
    ``batch_sum`` over both: their scores and row gradients are the whole
    batch's, and the sums of their parameter gradients the whole batch's
    (float64, 1e-10); the all-masked batch too, with its loss unmasked."""
    conv, rows, mask, w = _inputs(d, masked, weighted, all_masked)
    p, r, m, wt = _tensors(conv, rows, mask, w, torch.float64)
    loss_mask = None if all_masked else m
    want_s, want = _grads(attr_conv.conv_score, p, r, m, wt, loss_mask)
    ranks, cut = _TwoRanks(), [slice(0, 10), slice(10, B)]

    def part(rank):
        part_of = lambda x: None if x is None else x[cut[rank]]  # noqa
        pp, rr, mm, ww = _tensors(conv, [x[cut[rank]] for x in rows],
                                  part_of(mask), part_of(w), torch.float64)
        bs = ranks.batch_sum(rank)
        return _grads(lambda *a, **k: attr_conv.conv_score(
            *a, **k, batch_sum=bs), pp, rr, mm, ww,
            None if all_masked else mm)

    with ThreadPoolExecutor(2) as pool:
        (s0, g0), (s1, g1) = [f.result(timeout=120) for f in
                              [pool.submit(part, k) for k in (0, 1)]]
    got = [torch.cat([a, b]) for a, b in zip(g0[:3], g1[:3])] + \
        [a + b for a, b in zip(g0[3:], g1[3:])]
    _assert_near([torch.cat([s0, s1])], [want_s], 1e-10)
    _assert_near(got, want, 1e-10)


@pytest.mark.parametrize("B_,d,want", [
    (5000, 75, (27, 192)), (4097, 75, (26, 160)), (5000, 384, (2, 2528)),
    (1, 75, (1, 32)), (100, 8, (4, 32))])
def test_weight_gradient_split(B_, d, want):
    """The weight gradient's rows in runs of a multiple of 32 that cover
    the batch, about 264 blocks with the tiles of dense_w."""
    splits, rows = k4.wgrad_split(B_, d)
    assert (splits, rows) == want
    assert rows % 32 == 0 and (splits - 1) * rows < B_ <= splits * rows


def test_kernels_refuse_what_they_do_not_take():
    """The checks that guard the card's path, run on CPU tensors: another
    layer count, padding, dtype or width raises before any launch."""
    conv, rows, mask, _ = _inputs(8, True, False)
    p = {k: torch.tensor(x, dtype=torch.float32) for k, x in conv.items()}
    h, a, v = (torch.tensor(x, dtype=torch.float32) for x in rows)
    m = torch.tensor(mask, dtype=torch.float32)
    k4._check(p, h, a, v, m, 2, k4.TF_SAME_PAD)
    with pytest.raises(ValueError, match="layer_num"):
        k4._check(p, h, a, v, m, 3, k4.TF_SAME_PAD)
    with pytest.raises(ValueError, match="SAME"):
        k4._check(p, h, a, v, m, 2, (2, 1, 1, 0))
    with pytest.raises(TypeError):
        k4._check(p, h.double(), a, v, m, 2, k4.TF_SAME_PAD)
    with pytest.raises(ValueError, match="dense_w"):
        k4._check({**p, "dense_w": p["dense_w"][:-1]}, h, a, v, m, 2,
                  k4.TF_SAME_PAD)
    wide = torch.zeros(2, k4.MAX_DIM + 1)
    with pytest.raises(ValueError, match="0 < d"):
        k4._check(p, wide, wide, wide, None, 2, k4.TF_SAME_PAD)
