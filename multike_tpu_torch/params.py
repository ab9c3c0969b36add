"""Model parameters: embedding tables, view->shared mappings, conv scorers
(counterpart of multike_tpu/params.py).

The parameters are a plain dict of float32 tensors, in the JAX package's
names and layouts (conv weights as (kh, kw, in, out)), so the tests can copy
a reference parameter dict across with :func:`params_from_reference`.

Tables are stored raw; every read of ``rv_ent``, ``rel``, ``av_ent`` and
``ent`` is l2-normalized row-wise after the gather (row-wise l2 commutes with
the row gather, gradients included).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multike_tpu_torch.config import Config
from multike_tpu_torch.train.optimizers import state_from_optax
from multike_tpu_torch.utils.device import resolve_device

EPS_L2 = 1e-12  # tf.nn.l2_normalize epsilon


def l2_normalize(x: torch.Tensor, axis=None, batch_sum=None) -> torch.Tensor:
    """tf.nn.l2_normalize semantics: ``x * rsqrt(max(sum(x^2), eps))``.

    ``axis=None`` normalizes over the whole tensor. This is not
    ``F.normalize``, which divides by ``max(norm, eps)``. ``batch_sum``
    (``axis=None`` only): a function that sums the sum of squares over the
    parts of a batch that other ranks hold, so a part is normalized by the
    whole batch's norm."""
    if axis is None:
        sq = torch.sum(torch.square(x))
        if batch_sum is not None:
            sq = batch_sum(sq)
    else:
        sq = torch.sum(torch.square(x), dim=axis, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, EPS_L2))


def _xavier_normal(gen, shape, device):
    """tf.contrib.layers.xavier_initializer(uniform=False): normal truncated
    at 2 standard deviations, stddev = sqrt(2 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[0], shape[1]
    std = float(np.sqrt(2.0 / (fan_in + fan_out)))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def _glorot_uniform(gen, shape, fan_in, fan_out, device):
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-limit, limit, generator=gen)


def _orthogonal(gen, d, device):
    t = torch.empty((d, d), dtype=torch.float32, device=device)
    return torch.nn.init.orthogonal_(t, generator=gen)


def init_conv_params(gen, dim: int, device, feature_map_size: int = 2,
                     kernel=(2, 4), layer_num: int = 2) -> Dict[str, torch.Tensor]:
    """One conv-scorer parameter set, in the JAX package's layout."""
    kh, kw = kernel
    p: Dict[str, torch.Tensor] = {
        "bn_gamma": torch.ones((dim,), dtype=torch.float32, device=device),
        "bn_beta": torch.zeros((dim,), dtype=torch.float32, device=device),
    }
    in_ch = 1
    for i in range(layer_num):
        rf = kh * kw
        p[f"conv{i}_w"] = _glorot_uniform(gen, (kh, kw, in_ch, feature_map_size),
                                          rf * in_ch, rf * feature_map_size,
                                          device)
        p[f"conv{i}_b"] = torch.zeros((feature_map_size,), dtype=torch.float32,
                                      device=device)
        in_ch = feature_map_size
    flat = 2 * dim * feature_map_size
    p["dense_w"] = _glorot_uniform(gen, (flat, dim), flat, dim, device)
    p["dense_b"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def init_params(cfg: Config, entities_num: int, relations_num: int,
                attributes_num: int, seed: int | None = None,
                device=None) -> Dict:
    """The reference's variables with the same distributions as the JAX
    package (not the same numbers: the random streams differ)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed if seed is None else seed)
    d = cfg.dim
    return {
        "rv_ent": _xavier_normal(gen, (entities_num, d), device),
        "rel": _xavier_normal(gen, (relations_num, d), device),
        "av_ent": _xavier_normal(gen, (entities_num, d), device),
        "attr": _xavier_normal(gen, (attributes_num, d), device),
        "ent": _xavier_normal(gen, (entities_num, d), device),
        "nv_mapping": _orthogonal(gen, d, device),
        "rv_mapping": _orthogonal(gen, d, device),
        "av_mapping": _orthogonal(gen, d, device),
        "conv_av": init_conv_params(gen, d, device),
        "conv_ckge": init_conv_params(gen, d, device),
        "conv_ckga": init_conv_params(gen, d, device),
    }


def _tree_to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_tensors(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if not np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)


def params_from_reference(np_params: Dict, device=None) -> Dict:
    """The JAX package's parameter dict (numpy arrays, nested conv dicts,
    the same layouts) as this package's tensors."""
    return _tree_to_tensors(np_params, resolve_device(device))


def opt_states_from_reference(np_states: Dict, device=None) -> Dict:
    """The JAX package's per-stream optimizer states, as numpy, as this
    package's tensors: Adagrad accumulator dicts ({stream: {var: acc}})
    as they are, and optax states of Adam, Adadelta or SGD (tuples of
    NamedTuple states) as the slot dicts of ``train/optimizers.py``; an
    Adam ``count`` stays int32."""
    return _tree_to_tensors(
        {stream: state_from_optax(st) if isinstance(st, tuple) else st
         for stream, st in np_states.items()}, resolve_device(device))


def lookup_norm(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows then l2-normalize each row (normalize-on-read)."""
    return l2_normalize(table[idx], axis=-1)
