"""The per-slot loss's plain version (kernels/per_slot_loss.py) on the CPU.

Its closed-form loss and gradients are held against autograd of the
expression the port used before K5 (``chip_smoke.eager_lean_loss``) and
against ``jax.value_and_grad`` of the JAX package's loss, at widths 8, 75
and 384 and 1 or 10 slots a positive, with the positives' mask and the
slots' keep flags present or absent, with coins all head, all tail or
mixed, on an all-masked batch and on one positive. Inputs are made with
numpy from a seed. Tolerances are the float32 ones of
tests/test_torch_chunk_loss.py: the forward within rtol 1e-6, gradients
within rtol 1e-5 / atol 1e-6 (the closed form computes each distance
directly, where the yardsticks expand it, and sums in another order than
autograd's chain).

The kernel itself runs only on the card: tests/test_torch_cuda_kernels.py
holds it against this plain version (that file imports no JAX, which the
card's machine lacks)."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp

from chip_smoke import eager_lean_loss
from multike_tpu import losses as jl
from multike_tpu_torch import losses as tl
from multike_tpu_torch import params as tp
from multike_tpu_torch import sampling as ts
from multike_tpu_torch.config import Config
from multike_tpu_torch.kernels import per_slot_loss as k5
from multike_tpu_torch.train import streams as tst
from multike_tpu_torch.utils import profiling

FWD = dict(rtol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
NAMES = ("phs", "prs", "pts", "cand_rows")


def _inputs(seed, b, k, d, masks, coins):
    """Unit rows, the coins (``coins`` "head", "tail" or "mixed") and the
    masks: ``masks`` "mask", "keep", "both", "all_masked" (a mask of
    zeros, with keep flags) or None."""
    rng = np.random.RandomState(seed)

    def rows(*shape):
        x = rng.randn(*shape, d).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    ins = dict(phs=rows(b), prs=rows(b), pts=rows(b), cand_rows=rows(b, k))
    head = {"head": np.ones((b, k), bool), "tail": np.zeros((b, k), bool),
            "mixed": rng.rand(b, k) > 0.5}[coins]
    kw = {}
    if masks in ("mask", "both"):
        kw["pos_mask"] = (rng.rand(b) > 0.3).astype(np.float32)
    if masks == "all_masked":
        kw["pos_mask"] = np.zeros(b, np.float32)
    if masks in ("keep", "both", "all_masked"):
        kw["neg_keep"] = (rng.rand(b, k) > 0.2).astype(np.float32)
    return ins, head, kw


CASES = [  # b, k, d, masks, coins
    (37, 10, 75, "both", "mixed"),
    (37, 10, 75, None, "mixed"),
    (20, 1, 75, "mask", "head"),
    (20, 1, 8, "keep", "tail"),
    (9, 10, 8, "both", "head"),
    (9, 10, 8, None, "tail"),
    (13, 10, 384, "both", "mixed"),
    (13, 1, 384, None, "mixed"),
    (16, 10, 75, "all_masked", "mixed"),
    (1, 10, 75, "both", "mixed"),
    (1, 1, 8, None, "head"),
]


@pytest.mark.parametrize("b,k,d,masks,coins", CASES)
def test_plain_matches_autograd_and_jax(b, k, d, masks, coins):
    ins, head_np, kw_np = _inputs(b * 1000 + k * 10 + d, b, k, d, masks,
                                  coins)
    kw_t = {n: torch.tensor(v) for n, v in kw_np.items()}
    head = torch.tensor(head_np)
    xs = [torch.tensor(ins[n]) for n in NAMES]

    loss, grads = k5.per_slot_loss_plain(*xs, head, **kw_t)
    assert loss.dtype == torch.float32
    if masks == "all_masked":
        assert loss.item() == 0.0
        assert all(not g.any() for g in grads)

    leaves = [x.clone().requires_grad_() for x in xs]
    want = eager_lean_loss(*leaves, head, **kw_t)
    want_g = torch.autograd.grad(want, leaves)
    np.testing.assert_allclose(loss.item(), want.item(), **FWD)
    for n, g, wg in zip(NAMES, grads, want_g):
        assert g.shape == wg.shape, n
        np.testing.assert_allclose(g.numpy(), wg.numpy(), **GRAD, err_msg=n)

    def jax_loss(*a):
        return jl.lean_relation_logistic_loss(
            *a, jnp.asarray(head_np),
            **{n: jnp.asarray(v) for n, v in kw_np.items()})

    j_loss, j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(ins[n]) for n in NAMES))
    np.testing.assert_allclose(loss.item(), float(j_loss), **FWD)
    for n, g, jg in zip(NAMES, grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD,
                                   err_msg=n)

    # through the wrapper: the same loss, bitwise, with a gradient wanted
    # and without
    with_grad = k5.per_slot_loss(*leaves, head, **kw_t)
    with torch.no_grad():
        no_grad = k5.per_slot_loss(*leaves, head, **kw_t)
    assert with_grad.requires_grad and not no_grad.requires_grad
    assert torch.equal(no_grad, with_grad.detach())
    assert torch.equal(no_grad, loss)


def test_autograd_hands_over_the_stashed_gradients_scaled():
    """Through ``losses.lean_relation_logistic_loss``: the backward scales
    the forward's gradients by the incoming gradient, exactly, for the
    whole batch and for the half_batch fault's first half
    (``a[:B // 2]``); with no gradient wanted the loss is the same."""
    ins, head_np, kw_np = _inputs(5, 40, 10, 75, "both", "mixed")
    kw = {n: torch.tensor(v) for n, v in kw_np.items()}
    xs = [torch.tensor(ins[n]) for n in NAMES] + [torch.tensor(head_np)]
    half = [x[:20] for x in xs]
    kw_half = {n: v[:20] for n, v in kw.items()}
    for args, kws in ((xs, kw), (half, kw_half)):
        leaves = [x.detach().clone().requires_grad_() for x in args[:4]]
        loss = tl.lean_relation_logistic_loss(*leaves, args[4], **kws)
        got = torch.autograd.grad(2.5 * loss, leaves)
        want_loss, want = k5.per_slot_loss_plain(*args, **kws)
        assert torch.equal(loss.detach(), want_loss)
        for g, wg, x in zip(got, want, args):
            assert g.shape == x.shape
            assert torch.equal(g, wg * 2.5)
        with torch.no_grad():
            assert torch.equal(tl.lean_relation_logistic_loss(*args, **kws),
                               want_loss)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ins, head_np, _ = _inputs(6, 4, 3, 13, None, "mixed")
    xs = [torch.tensor(ins[n]) for n in NAMES]
    head = torch.tensor(head_np)
    with pytest.raises(TypeError):                       # dtypes
        k5.per_slot_loss(*xs[:3], xs[3].double(), head)
    with pytest.raises(TypeError):
        k5.per_slot_loss(*xs, head.float())
    with pytest.raises(TypeError):
        k5.per_slot_loss(*xs, head, pos_mask=torch.ones(4, dtype=torch.int64))
    with pytest.raises(ValueError):                      # shapes
        k5.per_slot_loss(*xs[:3], xs[3][:, :2], head)
    with pytest.raises(ValueError):
        k5.per_slot_loss(xs[0][:3], *xs[1:], head)
    with pytest.raises(ValueError):
        k5.per_slot_loss(*xs, head, pos_mask=torch.ones(5))
    with pytest.raises(ValueError):
        k5.per_slot_loss(*xs, head, neg_keep=torch.ones(4, 2))
    with pytest.raises(ValueError):
        k5.per_slot_loss(*(x[:, :0] if x.dim() == 2 else x[..., :0]
                           for x in xs), head)
    meta = [x.to("meta") for x in xs]                    # devices
    with pytest.raises(ValueError):
        k5.per_slot_loss(*xs[:3], meta[3], head)
    with pytest.raises(ValueError):
        k5.per_slot_loss(*meta, head.to("meta"))


def test_cpu_per_slot_epoch_counts_its_slot_pairs():
    """A per-slot relation-view epoch on the CPU calls the loss once a KG a
    step, under a profiler session: ``loss.slot_pairs`` = steps x (bs1 +
    bs2) x K; without a session it counts nothing."""
    E, R = 40, 5
    rng = np.random.RandomState(0)
    rows = lambda n, lo, hi: torch.as_tensor(np.stack(  # noqa: E731
        [rng.randint(lo, hi, n), rng.randint(0, R, n),
         rng.randint(lo, hi, n)], 1))
    t1, t2 = rows(200, 0, 20), rows(150, 20, 40)
    tf = ts.build_triple_filter(torch.cat([t1, t2]).numpy(), log2m=14)
    cfg = Config(dim=8, batch_size=64, neg_triple_num=3, learning_rate=0.05,
                 neg_scheme="per_slot", neg_reject_mode="drop")
    params = tp.init_params(cfg, E, R, 2, device="cpu")
    opt = tst.init_stream_opt_states(cfg, params)["rel_view"]
    epoch, steps, _ = tst.build_rel_view_epoch(cfg, len(t1), len(t2),
                                               ((0, 20), (20, 40)),
                                               tfilter=tf)
    assert epoch.scheme == "per_slot"
    gen = torch.Generator().manual_seed(0)
    profiling.drain()
    epoch(params, opt, gen, t1, t2)
    assert profiling.drain()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        epoch(params, opt, gen, t1, t2)
    counters = profiling.drain()["counters"]
    assert counters["loss.slot_pairs"] == \
        steps * (epoch.bs1 + epoch.bs2) * cfg.neg_triple_num
    assert set(counters) <= set(profiling.COUNTERS)
    assert k5.launches == 0              # the CPU takes the plain version
