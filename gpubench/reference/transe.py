"""Plain reference of MultiKE's relation-view training step.

MultiKE (Zhang et al., IJCAI 2019) trains the relation view as TransE with
a logistic loss: a positive triple (h, r, t) adds softplus(||h + r - t||^2)
and a negative (h', r, t') adds softplus(-||h' + r - t'||^2); every row is
l2-normalized as it is read (``x / sqrt(max(sum x^2, 1e-12))``, TF's
``l2_normalize``), and the tables train by TF1's Adagrad as the reference
configures it (initial accumulator 0.1; ``acc += g^2``, ``p -= lr g /
sqrt(acc + 1e-7)``, the JAX package's optax form).

Negatives come in two schemes:

  * per-slot (the reference's own): each positive has K slots, each with
    its own candidate for the head or the tail, and a keep flag (0 where
    the slot is dropped as a true triple);
  * chunk-shared (the port's default): the positives of a chunk share a
    head pool and a tail pool of C candidates each, every positive meets
    all 2C at weight K / (2C) (the K per-slot draws in expectation).

The step is computed from the whole tables, in float64 (``FLOAT64``), or
as the control (``TF32``): float32 with every normalized row rounded to
TF32's 10 mantissa bits where it enters a product, which is what the
tensor cores' TF32 mode does to the operands of a float32 matmul.

The loss is built in blocks (one chunk, or one KG's slots) whose backward
runs at once into the gathered rows, so the chunk scheme's (S, C, d)
differences never exist for all chunks together.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ACC0 = 0.1          # TF1 Adagrad's initial_accumulator_value in MultiKE
ADAGRAD_EPS = 1e-7
L2_EPS = 1e-12


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool


FLOAT64 = Precision(torch.float64, False)
TF32 = Precision(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 explicit mantissa
    bits), ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True),
                                          L2_EPS))


def distance(h, r, t):
    """||h + r - t||^2 over the last axis."""
    diff = h + r - t
    return (diff * diff).sum(-1)


def softplus(x):
    return torch.logaddexp(torch.zeros_like(x), x)


class Reads:
    """Normalized row reads of the tables, each a leaf whose gradient the
    loss blocks fill; :meth:`grads` carries them back to the tables."""

    def __init__(self, tables: dict, prec: Precision):
        self.tables = {k: v.detach().requires_grad_() for k, v in
                       tables.items()}
        self.prec = prec
        self.pairs = []

    def __call__(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        rows = normalize(self.tables[name][ids.long()])
        if self.prec.tf32:
            rows = rows + (tf32_round(rows) - rows).detach()
        leaf = rows.detach().requires_grad_()
        self.pairs.append((rows, leaf))
        return leaf

    def grads(self) -> dict:
        used = [(r, l.grad) for r, l in self.pairs if l.grad is not None]
        torch.autograd.backward([r for r, _ in used], [g for _, g in used])
        return {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                for k, t in self.tables.items()}


def _block(loss: torch.Tensor) -> float:
    loss.backward()
    return float(loss.detach())


def chunk_shared_loss(read: Reads, kgs, neg_num: int) -> float:
    """The chunk-shared loss of one step. ``kgs``: per KG a dict with
    ``pos`` (nc * s, 3) positives laid out chunk by chunk, ``mask`` (nc *
    s,) 1 for a real positive, ``ch`` and ``ct`` (nc, C) the head and the
    tail pools."""
    total = 0.0
    for kg in kgs:
        ch, ct = kg["ch"], kg["ct"]
        nc, pool = ch.shape
        s = kg["pos"].shape[0] // nc
        w = neg_num / (2.0 * pool)
        pos = kg["pos"].reshape(nc, s, 3)
        mask = kg["mask"].reshape(nc, s)
        for c in range(nc):
            m = mask[c].to(read.prec.dtype)
            h = read("rv_ent", pos[c, :, 0])
            r = read("rel", pos[c, :, 1])
            t = read("rv_ent", pos[c, :, 2])
            cand_h = read("rv_ent", ch[c])
            cand_t = read("rv_ent", ct[c])
            loss = (softplus(distance(h, r, t)) * m).sum()
            neg_h = distance(cand_h[None, :, :], (r - t)[:, None, :], 0.0)
            neg_t = distance((h + r)[:, None, :], 0.0, cand_t[None, :, :])
            loss = loss + w * ((softplus(-neg_h) + softplus(-neg_t))
                               * m[:, None]).sum()
            total += _block(loss)
    return total


def per_slot_loss(read: Reads, kgs) -> float:
    """The per-slot loss of one step. ``kgs``: per KG a dict with ``pos``
    (B, 3), ``mask`` (B,), ``cand`` (B, K) candidates, ``head`` (B, K) True
    where the slot corrupts the head, ``keep`` (B, K) 1.0 or 0.0."""
    total = 0.0
    for kg in kgs:
        pos, head = kg["pos"], kg["head"]
        m = kg["mask"].to(read.prec.dtype)
        keep = kg["keep"].to(read.prec.dtype)
        h = read("rv_ent", pos[:, 0])
        r = read("rel", pos[:, 1])
        t = read("rv_ent", pos[:, 2])
        c = read("rv_ent", kg["cand"].reshape(-1)).reshape(
            *kg["cand"].shape, -1)
        hs = torch.where(head[..., None], c, h[:, None, :])
        ts = torch.where(head[..., None], t[:, None, :], c)
        neg = distance(hs, r[:, None, :], ts)
        loss = (softplus(distance(h, r, t)) * m).sum() \
            + (softplus(-neg) * keep * m[:, None]).sum()
        total += _block(loss)
    return total


def adagrad(param: torch.Tensor, acc: torch.Tensor, grad: torch.Tensor,
            lr: float):
    acc += grad * grad
    param -= lr * grad / torch.sqrt(acc + ADAGRAD_EPS)


def follow(tables: dict, steps, loss_fn, lr: float,
           prec: Precision = FLOAT64) -> dict:
    """Trains copies of ``tables`` (name -> float32 tensor, the state before
    the first step) through ``steps`` (each the batch ``loss_fn(read,
    batch)`` takes) from fresh accumulators. Returns each step's loss, each
    table's first-gradient norm and each table's change after the last
    step, as float64 numbers."""
    p = {k: v.to(prec.dtype).clone() for k, v in tables.items()}
    acc = {k: torch.full_like(v, ACC0) for k, v in p.items()}
    losses, grad_norms = [], None
    for batch in steps:
        read = Reads(p, prec)
        losses.append(loss_fn(read, batch))
        grads = read.grads()
        if grad_norms is None:
            grad_norms = {k: float(g.double().norm()) for k, g in
                          grads.items()}
        with torch.no_grad():
            for k in p:
                adagrad(p[k], acc[k], grads[k].to(prec.dtype), lr)
    delta = {k: float((p[k].double() - tables[k].double()).norm())
             for k in p}
    return dict(losses=losses, grad_norms=grad_norms, delta_norms=delta)
