"""Literal autoencoder (counterpart of multike_tpu/text/autoencoder.py).

Encoder ``input_dim`` -> 1024 -> 512 -> dim with a mirrored decoder;
weights and biases start standard normal, stored (in, out) under the JAX
package's names (``enc_w0``, ``enc_b0``, ..., ``dec_w0``, ...), so
:func:`autoencoder_params_from_reference` carries a JAX initialisation
across.

Quirks of the reference that are kept:
  * ``encoder_active='thah'`` (the reference config's typo) matches
    neither 'sigmoid' nor 'tanh', so every layer is linear;
  * with ``encoder_normalize`` each input row is l2-normalized once, and
    inside the training loss the code ``h`` is divided by the Frobenius
    norm of the whole batch, after the padded rows are zeroed;
  * ``encode`` runs the raw encoder, with no normalization of its output;
  * the optimizer is optax's Adagrad (accumulator from 0.1, eps 1e-7
    inside the rsqrt: ``train.sparse_adagrad.dense_apply``), over batches
    of ``batch_size`` rows in order, the last one smaller.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from multike_tpu_torch.config import Config
from multike_tpu_torch.train.sparse_adagrad import dense_apply, init_acc
from multike_tpu_torch.utils.device import resolve_device


def activation(name: str):
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    return lambda x: x            # 'thah' and anything else: identity


class AutoEncoder(nn.Module):
    """Trains on a fixed (n, input_dim) matrix; ``forward`` is the encoder,
    :meth:`encode` its batched host-array form."""

    def __init__(self, word_vec_mat: np.ndarray, cfg: Config,
                 input_dim: int = 1500, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.input_dim = input_dim
        self.n_layers = len(cfg.hidden_dims)
        self.act = activation(cfg.encoder_active)
        dev = resolve_device(device)

        gen = torch.Generator(device=dev).manual_seed(seed)
        dims = [input_dim] + list(cfg.hidden_dims)
        shapes = {}
        for i in range(self.n_layers):
            shapes[f"enc_w{i}"] = (dims[i], dims[i + 1])
            shapes[f"enc_b{i}"] = (dims[i + 1],)
        for i in range(self.n_layers):
            j = self.n_layers - i
            shapes[f"dec_w{i}"] = (dims[j], dims[j - 1])
            shapes[f"dec_b{i}"] = (dims[j - 1],)
        self.weights = nn.ParameterDict({
            k: nn.Parameter(torch.randn(s, generator=gen, device=dev))
            for k, s in shapes.items()})
        self.acc = {k: init_acc(p.detach()) for k, p in self.weights.items()}

        x = np.asarray(word_vec_mat, np.float32).reshape(-1, input_dim)
        if cfg.encoder_normalize:
            norms = np.linalg.norm(x, axis=1, keepdims=True)
            x = np.where(norms > 0, x / np.maximum(norms, 1e-30), x)
        n = x.shape[0]
        bs = min(cfg.batch_size, max(n, 1))
        steps = max(1, -(-n // bs))
        pad = steps * bs - n
        self._xp = torch.as_tensor(np.concatenate(
            [x, np.zeros((pad, input_dim), np.float32)]).reshape(
                steps, bs, input_dim), device=dev)
        self._wp = torch.as_tensor(np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad, np.float32)]).reshape(
                steps, bs), device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            h = self.act(h @ self.weights[f"enc_w{i}"]
                         + self.weights[f"enc_b{i}"])
        return h

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            h = self.act(h @ self.weights[f"dec_w{i}"]
                         + self.weights[f"dec_b{i}"])
        return h

    def batch_loss(self, xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
        h = self(xb) * wb[:, None]      # padded rows out of the batch norm
        if self.cfg.encoder_normalize:
            h = h / torch.clamp_min(torch.linalg.norm(h), 1e-30)
        dec = self.decode(h)
        sq = torch.sum(torch.square(dec - xb) * wb[:, None])
        return sq / (torch.clamp_min(torch.sum(wb), 1.0) * self.input_dim)

    def train_epoch(self) -> torch.Tensor:
        """One pass over the batches; returns the summed batch losses."""
        total = torch.zeros((), device=self._xp.device)
        names = list(self.weights.keys())
        for xb, wb in zip(self._xp, self._wp):
            loss = self.batch_loss(xb, wb)
            grads = torch.autograd.grad(loss, list(self.weights.values()))
            with torch.no_grad():
                for k, g in zip(names, grads):
                    dense_apply(self.weights[k], self.acc[k], g,
                                self.cfg.learning_rate)
            total += loss.detach()
        return total

    def fit(self, epochs: int | None = None, verbose: bool = False):
        epochs = self.cfg.encoder_epoch if epochs is None else epochs
        for e in range(epochs):
            loss = self.train_epoch()
            if verbose and (e + 1) % 10 == 0:
                print(f"epoch {e + 1} of literal encoder, loss: "
                      f"{float(loss):.4f}")
        return self

    @torch.no_grad()
    def encode(self, data: np.ndarray) -> np.ndarray:
        """Raw encoder output (no normalization) of ``data``'s rows, in
        batches of ``batch_size``."""
        x = np.asarray(data, np.float32).reshape(-1, self.input_dim)
        dev = self._xp.device
        outs = [self(torch.as_tensor(x[i:i + self.cfg.batch_size],
                                     device=dev)).cpu().numpy()
                for i in range(0, len(x), self.cfg.batch_size)]
        return np.concatenate(outs, axis=0) if outs else np.zeros(
            (0, self.cfg.dim), np.float32)


def autoencoder_params_from_reference(ae: AutoEncoder,
                                      np_params: Dict[str, np.ndarray]):
    """Copy the JAX package's autoencoder parameters into ``ae`` and restart
    its accumulators. Returns ``ae``."""
    with torch.no_grad():
        for k, p in ae.weights.items():
            p.copy_(torch.tensor(np.asarray(np_params[k], np.float32)))
            ae.acc[k] = init_acc(p.detach())
    return ae
