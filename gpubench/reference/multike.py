"""Plain reference of MultiKE-ITC's training streams (Zhang et al., "Multi-view
Knowledge Graph Embedding for Entity Alignment", IJCAI 2019; the ITC
combination, ``MultiKE_CV`` in https://github.com/nju-websoft/MultiKE).

One ITC driver epoch trains seven losses in turn, each a sum over its batch
and each with its own Adagrad state at its own rate:

  * ``rel_view``: TransE with a logistic loss and chunk-shared negative
    pools (``reference/transe.py``);
  * ``ckge_rel``: ``2 sum softplus(||h + r - t||^2)`` over swapped
    supervision triples (cross-KG entity inference);
  * ``ckgp_rel``: ``2 sum w softplus(||h + r - t||^2)`` over the
    predicate-aligned 4-tuples (cross-KG relation inference);
  * ``attr_view``: ``sum m w softplus(-score(h, a, v))``, the CNN scorer
    ``conv_av``, over every attribute triple with its weight;
  * ``ckge_attr``: ``2 sum softplus(-score)``, scorer ``conv_ckge``, over
    swapped supervision attribute triples;
  * ``ckga_attr``: ``sum w softplus(-score)``, scorer ``conv_ckga``, over
    the predicate-aligned attribute 4-tuples;
  * ``common_space``: ``cv (cn sum ||e - n||^2 + sum ||e - r||^2 +
    sum ||e - a||^2)`` over a batch of entities.

Entity and relation rows are l2-normalized as they are read
(``transe.normalize``); attribute rows are read raw; the name (``n``) and
literal (``v``) vectors are constants. The CNN scorer, from the published
TF1 ``conv`` (MultiKE_model.py), on NHWC tensors:

  1. ``x = stack(a, v)``, (B, 2, d, 1);
  2. batch norm over axis 2 in inference mode with its moving statistics
     at their initial 0 and 1: ``gamma x / sqrt(1 + 1e-3) + beta``;
  3. two convolutions, kernel (2, 4), 2 feature maps, stride 1, TF's SAME
     padding (rows (0, 1), columns (1, 2): the extra row and column after),
     each followed by tanh;
  4. l2 normalization over axis 2;
  5. flatten (H, W, C order), dense to d with tanh, then the masked rows
     zeroed and one l2 normalization over the whole tensor;
  6. ``score = -||h - dense||^2``.

The convolution is written out as a sum over the kernel's eight offsets,
with no library convolution. Adagrad is the optax form of
``reference/transe.py`` (accumulators from 0.1, ``p -= lr g / sqrt(acc +
1e-7)``); ``common_space`` trains at ``ITC_learning_rate``, the rest at
``learning_rate``.

Departures from the published model, all shared with the program under
test: the literal and name vectors are inputs, not the literal
autoencoder's output; the attribute view's batches are of a fixed size with
their padding masked (the published code slices a shorter last batch),
which the mask keeps out of the whole-tensor norm; the chunk-shared pools
stand in for per-slot negatives (``reference/transe.py``).

``FLOAT64`` computes in float64; the control ``TF32`` in float32 with the
operands of every product that TF32 mode would round (the relation view's
normalized rows as ``reference/transe.py`` has it, and the CNN's
convolution and dense layer) rounded to TF32.
"""
from __future__ import annotations

from typing import Dict

import torch

from gpubench.reference import draws, transe
from gpubench.reference.transe import FLOAT64, Precision, normalize, softplus

BN_EPS = 1e-3
STREAMS = {        # stream -> the tables it trains
    "rel_view": ("rv_ent", "rel"),
    "ckge_rel": ("rv_ent", "rel"),
    "ckgp_rel": ("rv_ent", "rel"),
    "attr_view": ("av_ent", "attr", "conv_av"),
    "ckge_attr": ("av_ent", "attr", "conv_ckge"),
    "ckga_attr": ("av_ent", "attr", "conv_ckga"),
    "common_space": ("ent", "rv_ent", "av_ent"),
}
CONV_OF = {"attr_view": "conv_av", "ckge_attr": "conv_ckge",
           "ckga_attr": "conv_ckga"}


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A dict of tensors and dicts of tensors as one dict, the keys of a
    nested dict joined by dots (``conv_av.dense_w``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _round(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``x`` as TF32 mode would read it into a product, under the control;
    ``x`` itself otherwise."""
    return x + (transe.tf32_round(x) - x).detach() if prec.tf32 else x


def conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              prec: Precision = FLOAT64) -> torch.Tensor:
    """TF ``conv2d`` with stride 1 and SAME padding, NHWC input, kernel
    (kh, kw, in, out): the padding's extra row and column go after."""
    n, h, wd, cin = x.shape
    kh, kw = w.shape[:2]
    top, left = (kh - 1) // 2, (kw - 1) // 2
    padded = x.new_zeros((n, h + kh - 1, wd + kw - 1, cin))
    padded[:, top:top + h, left:left + wd] = x
    padded, w = _round(padded, prec), _round(w, prec)
    out = b
    for i in range(kh):
        for j in range(kw):
            out = out + (padded[:, i:i + h, j:j + wd, :, None]
                         * w[i, j]).sum(3)
    return out


def conv_score(conv: dict, hs, as_, vs, mask=None,
               prec: Precision = FLOAT64) -> torch.Tensor:
    """(B,) scores of the CNN scorer (the module's steps 1-6)."""
    x = torch.stack([as_, vs], dim=1)[..., None]
    x = conv["bn_gamma"][None, None, :, None] * x \
        / torch.sqrt(torch.tensor(1.0 + BN_EPS, dtype=x.dtype,
                                  device=x.device)) \
        + conv["bn_beta"][None, None, :, None]
    layer = 0
    while f"conv{layer}_w" in conv:
        x = torch.tanh(conv_same(x, conv[f"conv{layer}_w"],
                                 conv[f"conv{layer}_b"], prec))
        layer += 1
    x = x / torch.sqrt(torch.clamp_min((x * x).sum(2, keepdim=True),
                                       transe.L2_EPS))
    dense = torch.tanh(_round(x.reshape(x.shape[0], -1), prec)
                       @ _round(conv["dense_w"], prec) + conv["dense_b"])
    if mask is not None:
        dense = dense * mask[:, None]
    dense = dense / torch.sqrt(torch.clamp_min((dense * dense).sum(),
                                               transe.L2_EPS))
    return -((hs - dense) ** 2).sum(1)


def _pos_transe(p, batch, weighted: bool):
    pos = batch["pos"].long()
    h = normalize(p["rv_ent"][pos[:, 0]])
    r = normalize(p["rel"][pos[:, 1]])
    t = normalize(p["rv_ent"][pos[:, 2]])
    loss = softplus(transe.distance(h, r, t))
    if weighted:
        loss = loss * batch["w"].to(loss.dtype)
    return 2.0 * loss.sum()


def _conv_stream(stream, p, consts, batch, prec):
    pos = batch["pos"].long()
    h = normalize(p["av_ent"][pos[:, 0]])
    a = p["attr"][pos[:, 1]]
    v = consts["literal_embeds"][pos[:, 2]]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.to(h.dtype)
    loss = softplus(-conv_score(p[CONV_OF[stream]], h, a, v, mask, prec))
    if "w" in batch:
        loss = loss * batch["w"].to(loss.dtype)
    if mask is not None:
        loss = loss * mask
    return (2.0 if stream == "ckge_attr" else 1.0) * loss.sum()


def _common_space(p, consts, batch, cv_weight, cv_name_weight):
    ents = batch["ents"].long()
    e = normalize(p["ent"][ents])
    n = consts["name_embeds"][ents]
    r = normalize(p["rv_ent"][ents])
    a = normalize(p["av_ent"][ents])
    return cv_weight * (cv_name_weight * ((e - n) ** 2).sum()
                        + ((e - r) ** 2).sum() + ((e - a) ** 2).sum())


class Follower:
    """Float64 copies of every table, carried through the steps of an
    epoch stream by stream; each stream keeps its own Adagrad accumulators,
    made at 0.1 at its first step.

    ``tables``: name -> float32 tensor, or a dict of them for a CNN scorer
    (the state before the first step); ``constants``: ``name_embeds`` and
    ``literal_embeds``; ``rates``: stream -> learning rate; ``neg_num``
    the negatives a positive (the pools' pair weight); ``cv_weight`` and
    ``cv_name_weight`` the common space's weights."""

    def __init__(self, tables: dict, constants: dict, rates: dict,
                 neg_num: int, cv_weight: float, cv_name_weight: float,
                 prec: Precision = FLOAT64):
        self.prec = prec
        self.initial = {k: v.double() for k, v in flat(tables).items()}
        self.p = {k: {n: t.to(prec.dtype).clone() for n, t in v.items()}
                  if isinstance(v, dict) else v.to(prec.dtype).clone()
                  for k, v in tables.items()}
        self.consts = {k: v.to(prec.dtype) for k, v in constants.items()}
        self.rates, self.neg_num = rates, neg_num
        self.cv = (cv_weight, cv_name_weight)
        self.acc = {}

    def _loss(self, stream, p, batch):
        if stream in ("ckge_rel", "ckgp_rel"):
            return _pos_transe(p, batch, stream == "ckgp_rel")
        if stream in CONV_OF:
            return _conv_stream(stream, p, self.consts, batch, self.prec)
        if stream == "common_space":
            return _common_space(p, self.consts, batch, *self.cv)
        raise ValueError(f"no stream {stream!r}")

    def step(self, stream: str, batch) -> tuple:
        """One step of ``stream`` on ``batch`` (for ``rel_view`` the list of
        per-KG dicts that ``transe.chunk_shared_loss`` takes; otherwise a
        dict of ``pos``, ``w``, ``mask`` or ``ents``). Returns the loss and
        the gradient's norm of each of the stream's tables (flat keys)."""
        names = STREAMS[stream]
        mine = {k: self.p[k] for k in names}
        if stream == "rel_view":
            read = transe.Reads(mine, self.prec)
            loss = transe.chunk_shared_loss(read, batch, self.neg_num)
            grads = read.grads()
        else:
            leaves = flat(mine)
            for t in leaves.values():
                t.requires_grad_()
            out = self._loss(stream, mine, batch)
            grads = dict(zip(leaves, torch.autograd.grad(
                out, list(leaves.values()))))
            for t in leaves.values():
                t.requires_grad_(False)
            loss = float(out.detach())
        params = flat(mine)
        if stream not in self.acc:
            self.acc[stream] = {k: torch.full_like(v, transe.ACC0)
                                for k, v in params.items()}
        with torch.no_grad():
            for k, v in params.items():
                transe.adagrad(v, self.acc[stream][k],
                               grads[k].to(v.dtype), self.rates[stream])
        return loss, {k: float(g.double().norm()) for k, g in grads.items()}

    def delta_norms(self, stream: str) -> dict:
        """Each of ``stream``'s tables' change since the first step."""
        mine = flat({k: self.p[k] for k in STREAMS[stream]})
        return {k: float((v.double() - self.initial[k]).norm())
                for k, v in mine.items()}


def follow(tables: dict, constants: dict, steps, rates: dict, neg_num: int,
           cv_weight: float = 1.0, cv_name_weight: float = 1.0,
           prec: Precision = FLOAT64) -> dict:
    """Trains float64 copies of ``tables`` through ``steps``, a sequence of
    ``(stream, batch)`` in which each stream's steps come together (one
    driver epoch). Returns, by stream, its steps' ``losses``, its first
    gradient's norms (``grad_norms``) and, after its last step, the change
    of each of its tables since the first step of all (``delta_norms``);
    norms by flat table name."""
    f = Follower(tables, constants, rates, neg_num, cv_weight,
                 cv_name_weight, prec)
    out = {}
    steps = list(steps)
    for i, (stream, batch) in enumerate(steps):
        loss, norms = f.step(stream, batch)
        rec = out.setdefault(stream, {"losses": [], "grad_norms": norms})
        rec["losses"].append(loss)
        if i + 1 == len(steps) or steps[i + 1][0] != stream:
            rec["delta_norms"] = f.delta_norms(stream)
    return out


def pools_not_from_rows(pool: torch.Tensor, targets: torch.Tensor,
                        real: torch.Tensor, nbr: torch.Tensor,
                        cnt: torch.Tensor, lo: int, hi: int) -> int:
    """How many of a KG's chunk-shared pool candidates, ``pool`` (nc, C),
    lie outside [lo, hi) or outside the union of the neighbour rows of the
    entities that the chunk's real positives would have replaced
    (``targets`` (nc, s), ``real`` (nc, s) bool): the truncated phase draws
    each candidate from the row of one of them. A chunk where one of them
    has no row may draw uniformly, so there only the range counts.
    ``nbr`` (E, kmax) holds the rows, ``cnt`` (E,) their lengths."""
    bad = draws.out_of_range(pool, lo, hi)
    cols = torch.arange(nbr.shape[1], device=nbr.device)
    for c in range(pool.shape[0]):
        t = targets[c][real[c]].long()
        if t.numel() == 0 or bool((cnt[t] == 0).any()):
            continue
        mark = torch.zeros(hi, dtype=torch.bool, device=pool.device)
        mark[nbr[t][cols[None, :] < cnt[t][:, None]].long()] = True
        inside = (pool[c] >= lo) & (pool[c] < hi)
        bad += int((inside & ~mark[pool[c].clamp(0, hi - 1)]).sum())
    return bad
