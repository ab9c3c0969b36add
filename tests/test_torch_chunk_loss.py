"""The chunk-shared loss's plain version (kernels/chunk_loss.py) on the CPU.

Its closed-form loss and gradients are held against autograd of the
expression the port used before K3 (kept here as ``_autograd_loss``) and
against ``jax.value_and_grad`` of the JAX package's loss, over ragged
positive masks, keep masks present or absent, pair weights, chunks that are
not a multiple of the kernel's 64-row tile and widths 75, 384 and 13.
Inputs are made with numpy from a seed. Tolerances are the float32 ones of
tests/test_torch_params_losses.py: the forward within rtol 1e-6 (sums of a
few thousand terms in another order), gradients within rtol 1e-5 / atol
1e-6 (the closed form sums the pool products in another order than
autograd's chain).

The kernel itself runs only on the card: tests/test_torch_cuda_kernels.py
holds it against this plain version."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multike_tpu import losses as jl
from multike_tpu_torch import losses as tl
from multike_tpu_torch.kernels import chunk_loss as ck

FWD = dict(rtol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
NAMES = ("phs", "prs", "pts", "cand_h", "cand_t")


def _autograd_loss(phs, prs, pts, cand_h, cand_t, neg_weight=1.0,
                   pos_mask=None, keep_h=None, keep_t=None):
    """The port's chunk-shared loss before K3, differentiated by autograd."""
    def sq(x):
        return torch.sum(torch.square(x), dim=-1)

    pos = F.softplus(sq(phs + prs - pts))
    rt = prs - pts
    ns_h = -(sq(cand_h)[:, None, :] + sq(rt)[..., None]
             + 2.0 * torch.bmm(rt, cand_h.transpose(1, 2)))
    hr = phs + prs
    ns_t = -(sq(hr)[..., None] + sq(cand_t)[:, None, :]
             - 2.0 * torch.bmm(hr, cand_t.transpose(1, 2)))
    neg_h = F.softplus(ns_h)
    neg_t = F.softplus(ns_t)
    if keep_h is not None:
        neg_h = neg_h * keep_h
    if keep_t is not None:
        neg_t = neg_t * keep_t
    neg = (neg_h + neg_t) * neg_weight
    if pos_mask is not None:
        pos = pos * pos_mask
        neg = neg * pos_mask[..., None]
    return torch.sum(pos) + torch.sum(neg)


def _inputs(seed, nc, s, c, d, mask, keep):
    """Unit rows and the masks: ``mask`` "ragged" gives each chunk a real
    prefix and a padded tail, as the epochs' chunk padding does; ``keep``
    "both" or "head" gives Bloom-like keep flags."""
    rng = np.random.RandomState(seed)

    def rows(*shape):
        x = rng.randn(*shape, d).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    ins = dict(phs=rows(nc, s), prs=rows(nc, s), pts=rows(nc, s),
               cand_h=rows(nc, c), cand_t=rows(nc, c))
    kw = {}
    if mask == "ragged":
        real = rng.randint(s // 2, s, nc)
        kw["pos_mask"] = (np.arange(s)[None, :] < real[:, None]).astype(
            np.float32)
    if keep in ("both", "head"):
        kw["keep_h"] = (rng.rand(nc, s, c) > 0.2).astype(np.float32)
    if keep == "both":
        kw["keep_t"] = (rng.rand(nc, s, c) > 0.2).astype(np.float32)
    return ins, kw


CASES = [  # nc, s, c, d, mask, keep, neg_weight
    (2, 70, 9, 75, "ragged", "both", 10 / 256),
    (1, 64, 16, 75, None, None, 1.0),
    (2, 70, 9, 384, "ragged", None, 10 / 256),
    (1, 9, 5, 384, None, "both", 0.5),
    (3, 130, 12, 13, "ragged", "both", 1.0),
    (2, 65, 7, 13, None, "head", 10 / 256),
]


@pytest.mark.parametrize("nc,s,c,d,mask,keep,w", CASES)
def test_plain_matches_autograd_and_jax(nc, s, c, d, mask, keep, w):
    ins, kw_np = _inputs(nc * 1000 + s + d, nc, s, c, d, mask, keep)
    kw_t = {k: torch.tensor(v) for k, v in kw_np.items()}
    xs = [torch.tensor(ins[n]) for n in NAMES]

    loss, grads = ck.chunk_shared_loss_plain(*xs, neg_weight=w, **kw_t)
    assert loss.dtype == torch.float32

    leaves = [x.clone().requires_grad_() for x in xs]
    want = _autograd_loss(*leaves, neg_weight=w, **kw_t)
    want_g = torch.autograd.grad(want, leaves)
    np.testing.assert_allclose(loss.item(), want.item(), **FWD)
    for n, g, wg in zip(NAMES, grads, want_g):
        np.testing.assert_allclose(g.numpy(), wg.numpy(), **GRAD, err_msg=n)

    def jax_loss(*a):
        return jl.chunk_shared_relation_logistic_loss(
            *a, neg_weight=w, **{k: jnp.asarray(v) for k, v in kw_np.items()})

    j_loss, j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(ins[n]) for n in NAMES))
    np.testing.assert_allclose(loss.item(), float(j_loss), **FWD)
    for n, g, jg in zip(NAMES, grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD,
                                   err_msg=n)

    # with no gradient wanted: the same path, the same loss, bitwise
    with_grad = ck.chunk_shared_loss(*leaves, neg_weight=w, **kw_t)
    with torch.no_grad():
        no_grad = ck.chunk_shared_loss(*leaves, neg_weight=w, **kw_t)
    assert not no_grad.requires_grad
    assert torch.equal(no_grad, with_grad.detach())
    assert torch.equal(no_grad, loss)


def test_autograd_hands_over_the_stashed_gradients_scaled():
    """Through ``losses.chunk_shared_relation_logistic_loss``: the backward
    scales the forward's gradients by the incoming gradient, exactly; the
    fault plant's strided half views (``a[:, :S // 2]``) are taken; with no
    gradient wanted the loss is the same."""
    ins, kw_np = _inputs(5, 2, 70, 9, 75, "ragged", "both")
    kw = {k: torch.tensor(v) for k, v in kw_np.items()}
    xs = [torch.tensor(ins[n]) for n in NAMES]
    half = [x[:, :35] if i < 3 else x for i, x in enumerate(xs)]
    kw_half = {k: v[:, :35] for k, v in kw.items()}
    assert not half[0].is_contiguous()
    for args, kws in ((xs, kw), (half, kw_half)):
        leaves = [x.detach().clone().requires_grad_() if x.is_contiguous()
                  else x.detach().requires_grad_() for x in args]
        loss = tl.chunk_shared_relation_logistic_loss(*leaves, neg_weight=0.4,
                                                      **kws)
        got = torch.autograd.grad(2.5 * loss, leaves)
        want_loss, want = ck.chunk_shared_loss_plain(*args, neg_weight=0.4,
                                                     **kws)
        assert torch.equal(loss.detach(), want_loss)
        for g, wg, x in zip(got, want, args):
            assert g.shape == x.shape
            assert torch.equal(g, wg * 2.5)
        with torch.no_grad():
            assert torch.equal(tl.chunk_shared_relation_logistic_loss(
                *args, neg_weight=0.4, **kws), want_loss)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ins, _ = _inputs(6, 2, 8, 4, 13, None, None)
    xs = [torch.tensor(ins[n]) for n in NAMES]
    with pytest.raises(TypeError):
        ck.chunk_shared_loss(*xs[:4], xs[4].double())
    with pytest.raises(ValueError):
        ck.chunk_shared_loss(*xs[:4], xs[4][:, :3])
    with pytest.raises(ValueError):
        ck.chunk_shared_loss(*xs, pos_mask=torch.ones(2, 7))
    with pytest.raises(ValueError):
        ck.chunk_shared_loss(*xs, keep_t=torch.ones(2, 8, 5))
