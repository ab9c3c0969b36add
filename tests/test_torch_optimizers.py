"""The port's Adam, Adadelta and SGD against optax on the CPU.

* Three steps of each, from the same parameters (a nested conv dict
  included) and gradients, against ``optax.adam`` / ``adadelta`` / ``sgd``
  at rtol 1e-5 / atol 1e-7; the optax state, converted by
  ``opt_states_from_reference``, equals the port's.
* A dense stream step (ckge_rel) with each optimizer against the JAX
  package's ``_make_stream_update``; the row-sparse apply (K1) never runs.
* Checkpoints: the port writes the JAX package's optax keys, a JAX
  checkpoint of a non-Adagrad run loads into the port, and the reverse.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multike_tpu import losses as jl
from multike_tpu import params as jp
from multike_tpu import persistence as jpers
from multike_tpu.config import Config as JConfig
from multike_tpu.train import streams as jst
from multike_tpu_torch import params as tp
from multike_tpu_torch import persistence
from multike_tpu_torch.config import Config
from multike_tpu_torch.kernels import apply_kernel
from multike_tpu_torch.train import optimizers, streams as tst

TOL = dict(rtol=1e-5, atol=1e-7)
OPTAX = {"Adam": optax.adam, "Adadelta": optax.adadelta, "SGD": optax.sgd}
E, R, D = 30, 4, 8


def _tree(rng, scale=1.0):
    return {"rv_ent": (scale * rng.normal(size=(E, D))).astype(np.float32),
            "rel": (scale * rng.normal(size=(R, D))).astype(np.float32),
            "conv": {"w": (scale * rng.normal(size=(2, 4, 1, 2))).astype(
                         np.float32),
                     "b": (scale * rng.normal(size=(2,))).astype(np.float32)}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                  tree)


def _close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got))
    flat_w = jax.tree_util.tree_leaves(_np(want))
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, **(tol or TOL))


@pytest.mark.parametrize("name", ["Adam", "Adadelta", "SGD"])
def test_three_steps_match_optax(name):
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.3 * (i + 1)) for i in range(3)]
    lr = 0.05
    opt = OPTAX[name](lr)
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = opt.init(jparams)
    params = _torch(p0)
    state = optimizers.init_state(name, params)
    for g in grads:
        upd, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        optimizers.apply(name, params, state, _torch(g), lr)
        _close(params, jparams)
    converted = tp.opt_states_from_reference({"s": _np(jstate)},
                                             device="cpu")["s"]
    assert set(converted) == set(state) == {
        "Adam": {"count", "mu", "nu"}, "Adadelta": {"e_g", "e_x"},
        "SGD": set()}[name]
    for slot in state:
        if slot == "count":
            assert state[slot].dtype == converted[slot].dtype == torch.int32
            assert int(state[slot]) == int(converted[slot]) == 3
        else:
            _close(state[slot], converted[slot])


def _ckge_rel_jax(pos):
    def prep(p):
        return {"rv_ent": jnp.concatenate([p[:, 0], p[:, 2]])}, None

    def loss(rows, dense, stopped, aux, p):
        h = jp.l2_normalize(rows["rv_ent"], axis=-1)
        prs = jp.lookup_norm_fast(dense["rel"], p[:, 1])
        return 2.0 * jl.relation_logistic_loss_wo_negs(h[:len(pos)], prs,
                                                       h[len(pos):])
    return prep, loss


@pytest.mark.parametrize("name", ["Adam", "Adadelta", "SGD"])
def test_dense_stream_step_matches_jax(name, monkeypatch):
    kw = dict(dim=D, batch_size=16, learning_rate=0.05, optimizer=name,
              row_sparse_updates="on")
    cfg, jcfg = Config(**kw), JConfig(**kw)
    assert not tst.use_row_sparse(cfg, 10 ** 6, 1)   # dense, as in JAX

    def no_k1(*a, **k):
        raise AssertionError("K1 ran for a non-Adagrad optimizer")
    monkeypatch.setattr(apply_kernel, "row_adagrad", no_k1)
    monkeypatch.setattr(tst.sparse_adagrad, "row_adagrad", no_k1)

    rng = np.random.RandomState(1)
    np_params = {k: np.asarray(v) for k, v in
                 jp.init_params(JConfig(dim=D), E, R, 2).items()
                 if k in ("rv_ent", "rel")}
    pos = np.stack([rng.randint(0, E, 16), rng.randint(0, R, 16),
                    rng.randint(0, E, 16)], 1)
    epoch, _, _ = tst.build_ckge_rel_epoch(cfg, 16)
    jupdate = jax.jit(jst._make_stream_update(jcfg, "ckge_rel",
                                              *_ckge_rel_jax(pos)))
    jpar = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = jst.stream_optimizer(jcfg, "ckge_rel").init(jpar)
    params = tp.params_from_reference(np_params, device="cpu")
    state = tst.init_stream_opt_states(cfg, {
        **params, **{k: torch.zeros(1) for k in (
            "av_ent", "attr", "ent", "nv_mapping", "rv_mapping",
            "av_mapping", "conv_av", "conv_ckge", "conv_ckga")}})["ckge_rel"]
    for i in range(3):
        batch = np.roll(pos, i, axis=0)
        jpar, jstate, want = jupdate(jpar, jstate, jnp.asarray(batch))
        loss = epoch.step(params, state, torch.as_tensor(batch))
        np.testing.assert_allclose(float(loss), float(want), rtol=3e-5)
        _close(params, jpar, rtol=3e-5, atol=1e-6)
    if name != "SGD":
        _close(state, tp.opt_states_from_reference(
            {"s": _np(jstate)}, device="cpu")["s"], rtol=3e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["Adam", "Adadelta", "SGD"])
def test_non_adagrad_checkpoints_cross_load(name, tmp_path):
    kw = dict(dim=D, optimizer=name)
    jparams = jp.init_params(JConfig(**kw), E, R, 3)
    jstates = jst.init_stream_opt_states(JConfig(**kw), jparams)
    rng = np.random.RandomState(2)
    jstates = jax.tree_util.tree_map(
        lambda x: x + 3 if x.dtype == jnp.int32
        else x + rng.rand(*x.shape).astype(np.float32), jstates)
    path = str(tmp_path / "jax.npz")
    jpers.save_checkpoint(path, jparams, jstates, jax.random.PRNGKey(0), 4)

    cfg = Config(**kw)
    params = tp.init_params(cfg, E, R, 3, device="cpu")
    states = tst.init_stream_opt_states(cfg, params)
    want_keys = set(jpers._flatten_tree(jstates, "opt:"))
    got_keys = set(persistence._flat_paths(states, "opt:"))
    assert got_keys == want_keys
    if name == "Adam":
        assert "opt:['rel_view']/[0]/.count" in got_keys
        assert "opt:['rel_view']/[0]/.mu/['rv_ent']" in got_keys
        assert "opt:['attr_view']/[0]/.nu/['conv_av']/['dense_w']" in got_keys
    elif name == "Adadelta":
        assert "opt:['rel_view']/[1]/.e_g/['rv_ent']" in got_keys
    else:
        assert got_keys == set()
    assert persistence.load_checkpoint(path, params, states) == 4
    want = tp.opt_states_from_reference(_np(jstates), device="cpu")
    for k, t in persistence._flat_paths(states, "opt:").items():
        w = persistence._flat_paths(want, "opt:")[k]
        assert t.dtype == w.dtype
        np.testing.assert_array_equal(t.numpy(), w.numpy())
    _close(params, jparams, rtol=0, atol=0)

    # the reverse: a port checkpoint loads into the JAX package
    out = str(tmp_path / "port.npz")
    persistence.save_checkpoint(out, params, states, cfg.seed, 9)
    _, jloaded, _, epoch, _ = jpers.load_checkpoint(
        out, jparams, jax.tree_util.tree_map(jnp.zeros_like, jstates),
        jax.random.PRNGKey(0))
    assert epoch == 9
    for a, b in zip(jax.tree_util.tree_leaves(_np(jloaded)),
                    jax.tree_util.tree_leaves(_np(jstates))):
        np.testing.assert_array_equal(a, b)
