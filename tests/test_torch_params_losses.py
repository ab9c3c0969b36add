"""The PyTorch port's params.py and losses.py against the JAX package's.

Inputs are made with numpy from a seed and fed to both sides. Forward values
agree to rtol 1e-6 (float32, a few hundred summed terms in another order);
gradients from autograd agree with ``jax.grad`` to rtol 1e-5 / atol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multike_tpu import losses as jl
from multike_tpu import params as jp
from multike_tpu.config import Config as JConfig
from multike_tpu_torch import losses as tl
from multike_tpu_torch import params as tp
from multike_tpu_torch.config import Config

FWD = dict(rtol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


@pytest.mark.parametrize("axis", [-1, None])
def test_l2_normalize_matches(axis):
    rng = np.random.RandomState(0)
    x = rng.randn(7, 9).astype(np.float32)
    x[2] = 0.0                      # all-zero row: eps branch
    x[4] *= 1e-7                    # tiny row: below the eps floor
    want = np.asarray(jp.l2_normalize(jnp.asarray(x), axis=axis))
    got = tp.l2_normalize(_t(x), axis=axis).numpy()
    np.testing.assert_allclose(got, want, **FWD)


def test_l2_normalize_is_not_f_normalize():
    x = torch.full((1, 4), 1e-7)
    # tf semantics: x * rsqrt(max(sum x^2, 1e-12)) = x / 1e-6
    np.testing.assert_allclose(tp.l2_normalize(x, axis=-1).numpy(),
                               np.full((1, 4), 0.1, np.float32), rtol=1e-6)


def _chunk_inputs(seed, nc=3, s=5, c=4, d=8):
    rng = np.random.RandomState(seed)

    def rows(*shape):
        x = rng.randn(*shape, d).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    ins = dict(phs=rows(nc, s), prs=rows(nc, s), pts=rows(nc, s),
               cand_h=rows(nc, c), cand_t=rows(nc, c))
    mask = (rng.rand(nc, s) > 0.3).astype(np.float32)
    keep_h = (rng.rand(nc, s, c) > 0.2).astype(np.float32)
    keep_t = (rng.rand(nc, s, c) > 0.2).astype(np.float32)
    return ins, mask, keep_h, keep_t


@pytest.mark.parametrize("with_masks", [False, True])
def test_chunk_shared_loss_and_grads_match(with_masks):
    ins, mask, keep_h, keep_t = _chunk_inputs(1)
    kw_np = dict(neg_weight=10 / 8.0)
    if with_masks:
        kw_np.update(pos_mask=mask, keep_h=keep_h, keep_t=keep_t)
    names = list(ins)

    def jax_loss(*xs):
        kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in kw_np.items()}
        return jl.chunk_shared_relation_logistic_loss(*xs, **kw)

    jargs = [jnp.asarray(ins[n]) for n in names]
    want = float(jax_loss(*jargs))
    want_g = jax.grad(jax_loss, argnums=tuple(range(len(names))))(*jargs)

    targs = [_t(ins[n], grad=True) for n in names]
    kw_t = {k: _t(v) if isinstance(v, np.ndarray) else v
            for k, v in kw_np.items()}
    loss = tl.chunk_shared_relation_logistic_loss(*targs, **kw_t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, **FWD)
    for n, a, g in zip(names, targs, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD,
                                   err_msg=n)


@pytest.mark.parametrize("with_masks", [False, True])
def test_lean_loss_and_grads_match(with_masks):
    rng = np.random.RandomState(2)
    b, k, d = 6, 3, 8

    def rows(*shape):
        x = rng.randn(*shape, d).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    xs = [rows(b), rows(b), rows(b), rows(b, k)]
    corrupt_head = rng.rand(b, k) > 0.5
    mask = (rng.rand(b) > 0.3).astype(np.float32)
    keep = (rng.rand(b, k) > 0.2).astype(np.float32)

    def jax_loss(*a):
        kw = dict(pos_mask=jnp.asarray(mask), neg_keep=jnp.asarray(keep)) \
            if with_masks else {}
        return jl.lean_relation_logistic_loss(*a, jnp.asarray(corrupt_head),
                                              **kw)

    jargs = [jnp.asarray(x) for x in xs]
    want = float(jax_loss(*jargs))
    want_g = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*jargs)

    targs = [_t(x, grad=True) for x in xs]
    kw = dict(pos_mask=_t(mask), neg_keep=_t(keep)) if with_masks else {}
    loss = tl.lean_relation_logistic_loss(*targs, _t(corrupt_head), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, **FWD)
    for a, g in zip(targs, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD)


def test_positive_only_losses_match():
    rng = np.random.RandomState(3)
    h, r, t = (rng.randn(9, 6).astype(np.float32) for _ in range(3))
    mask = (rng.rand(9) > 0.3).astype(np.float32)
    want = float(jl.relation_logistic_loss_wo_negs(
        jnp.asarray(h), jnp.asarray(r), jnp.asarray(t), jnp.asarray(mask)))
    got = tl.relation_logistic_loss_wo_negs(_t(h), _t(r), _t(t), _t(mask))
    np.testing.assert_allclose(got.item(), want, **FWD)


def test_init_params_distributions():
    cfg = Config(dim=16, seed=4)
    E, R, A = 3000, 40, 20
    p = tp.init_params(cfg, E, R, A, device="cpu")
    jparams = jp.init_params(JConfig(dim=16, seed=4), E, R, A)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(p) == shapes(jparams)
    std = np.sqrt(2.0 / (E + 16))
    for name in ("rv_ent", "av_ent", "ent"):
        x = p[name].numpy()
        # truncated at 2 sigma: std of the truncated unit normal is 0.8796
        assert np.abs(x).max() <= 2 * std * (1 + 1e-6), name
        assert abs(x.std() / std - 0.8796) < 0.02, name
        assert abs(x.mean()) < 0.02 * std, name
        jx = np.asarray(jparams[name])
        assert abs(x.std() / jx.std() - 1) < 0.02, name
    eye = np.eye(16, dtype=np.float32)
    for name in ("nv_mapping", "rv_mapping", "av_mapping"):
        m = p[name].numpy()
        np.testing.assert_allclose(m @ m.T, eye, atol=1e-5)
    w = p["conv_av"]["dense_w"].numpy()
    limit = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    assert np.abs(w).max() <= limit and abs(w.std() / (limit / np.sqrt(3)) - 1) < 0.1
    # different seeds, different tables; same seed, same tables
    p2 = tp.init_params(cfg, E, R, A, device="cpu")
    assert torch.equal(p["rv_ent"], p2["rv_ent"])
    p3 = tp.init_params(cfg, E, R, A, seed=5, device="cpu")
    assert not torch.equal(p["rv_ent"], p3["rv_ent"])


def test_params_from_reference_roundtrip():
    jparams = jp.init_params(JConfig(dim=8), 30, 5, 4)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    got = tp.params_from_reference(np_params, device="cpu")
    assert got["conv_ckge"]["conv1_w"].shape == (2, 4, 2, 2)
    np.testing.assert_array_equal(got["rel"].numpy(), np_params["rel"])
    np.testing.assert_array_equal(got["conv_av"]["dense_w"].numpy(),
                                  np_params["conv_av"]["dense_w"])


def test_lookup_norm_fast_matches():
    """The port's ``lookup_norm`` against the JAX package's
    ``lookup_norm_fast`` (its one-hot gather for small tables)."""
    rng = np.random.RandomState(6)
    table = rng.randn(20, 8).astype(np.float32)
    idx = rng.randint(0, 20, 33)
    want = np.asarray(jp.lookup_norm_fast(jnp.asarray(table),
                                          jnp.asarray(idx)))
    got = tp.lookup_norm(_t(table), torch.as_tensor(idx)).numpy()
    np.testing.assert_allclose(got, want, **FWD)
