"""Chunk-shared TransE logistic loss (K3): the CUDA kernel in
``csrc/chunk_loss_kernel.cu`` and its plain PyTorch version.

K3 replaces no TPU kernel: the JAX package's
multike_tpu/losses.py::chunk_shared_relation_logistic_loss is plain jnp,
which XLA fuses. Run eagerly, the same expression is some 45 ops a KG and
as many autograd nodes, which set the relation view's step time on the
card. :func:`chunk_shared_loss` computes the loss and, in the same pass,
its gradients with respect to the five row tensors; an autograd
``Function`` hands them to autograd scaled by the incoming gradient (one
elementwise op over one flat buffer).

With ``phs/prs/pts`` (NC, S, D), ``cand_h/cand_t`` (NC, C, D), the
positives' mask ``pos_mask`` (NC, S) and the pairs' ``keep_h/keep_t`` (NC,
S, C), each optional::

    loss = sum m softplus(|h + r - t|^2)
         + w sum m keep_h softplus(-|c_h + r - t|^2)
         + w sum m keep_t softplus(-|h + r - c_t|^2)

The tensors' device picks the path: on the CPU the plain version
(:func:`chunk_shared_loss_plain`: the closed-form loss and gradients, the
distances expanded into batched matmuls); on a CUDA device the kernel (the
distances computed directly), or an error. ``launches`` counts the calls
that launched it, and each launch adds its pairs, NC x S x 2C, to the
``loss.chunk_pairs`` counter while a profiler session runs, so a trace of
the card shows that every chunk step ran the kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from multike_tpu_torch.kernels import _build
from multike_tpu_torch.utils.profiling import count

launches = 0
_ROWS = 64               # = kRows in csrc/chunk_loss_kernel.cu


def _sq_norm(x):
    return torch.sum(torch.square(x), dim=-1)


def chunk_shared_loss_plain(phs, prs, pts, cand_h, cand_t, neg_weight=1.0,
                            pos_mask=None, keep_h=None, keep_t=None):
    """``(loss, grads)``: the loss and its gradients with respect to
    ``(phs, prs, pts, cand_h, cand_t)`` in closed form. With x = r - t for
    the head pool and x = -(h + r) for the tail pool, a pair's coefficient
    k = -2 w m keep sigmoid(-|c + x|^2) gives
    g_x = sum_j k c_j + (sum_j k) x and g_c = sum_i k x_i + (sum_i k) c."""
    a = phs + prs - pts
    sq = _sq_norm(a)                                                # (NC, S)
    m = torch.ones_like(sq) if pos_mask is None else pos_mask
    rt = prs - pts
    hr = phs + prs
    dist_h = (_sq_norm(cand_h)[:, None, :] + _sq_norm(rt)[..., None]
              + 2.0 * torch.bmm(rt, cand_h.transpose(1, 2)))        # (NC, S, C)
    dist_t = (_sq_norm(hr)[..., None] + _sq_norm(cand_t)[:, None, :]
              - 2.0 * torch.bmm(hr, cand_t.transpose(1, 2)))
    wk_h = neg_weight * m[..., None]
    wk_t = wk_h
    if keep_h is not None:
        wk_h = wk_h * keep_h
    if keep_t is not None:
        wk_t = wk_t * keep_t
    loss = (torch.sum(F.softplus(sq) * m)
            + torch.sum(F.softplus(-dist_h) * wk_h)
            + torch.sum(F.softplus(-dist_t) * wk_t))
    g_pos = (2.0 * m * torch.sigmoid(sq))[..., None] * a
    k_h = -2.0 * wk_h * torch.sigmoid(-dist_h)
    k_t = -2.0 * wk_t * torch.sigmoid(-dist_t)
    g_rt = torch.bmm(k_h, cand_h) + k_h.sum(-1)[..., None] * rt
    g_ch = torch.bmm(k_h.transpose(1, 2), rt) + k_h.sum(1)[..., None] * cand_h
    g_hr = k_t.sum(-1)[..., None] * hr - torch.bmm(k_t, cand_t)
    g_ct = k_t.sum(1)[..., None] * cand_t - torch.bmm(k_t.transpose(1, 2), hr)
    return loss, (g_pos + g_hr, g_pos + g_rt + g_hr, -g_pos - g_rt, g_ch,
                  g_ct)


def _check(phs, prs, pts, cand_h, cand_t, pos_mask, keep_h, keep_t):
    nc, s, d = phs.shape if phs.dim() == 3 else (None,) * 3
    c = cand_h.shape[1] if cand_h.dim() == 3 else None
    want = {"phs": (nc, s, d), "prs": (nc, s, d), "pts": (nc, s, d),
            "cand_h": (nc, c, d), "cand_t": (nc, c, d),
            "pos_mask": (nc, s), "keep_h": (nc, s, c), "keep_t": (nc, s, c)}
    got = dict(phs=phs, prs=prs, pts=pts, cand_h=cand_h, cand_t=cand_t,
               pos_mask=pos_mask, keep_h=keep_h, keep_t=keep_t)
    for name, x in got.items():
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != phs.device:
            raise ValueError(f"{name} is on {x.device}, phs on {phs.device}")
        if None in want[name] or tuple(x.shape) != want[name]:
            raise ValueError(f"{name} {tuple(x.shape)} does not match "
                             f"{want[name]} (phs {tuple(phs.shape)}, cand_h "
                             f"{tuple(cand_h.shape)})")
    if d == 0:
        raise ValueError("rows of width 0")
    if nc >= 2 ** 16 or s >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError(f"{nc} chunks of {s} rows and pools of {c}: the "
                         "kernel takes under 65,536 chunks")


def _launch(phs, prs, pts, cand_h, cand_t, neg_weight, pos_mask, keep_h,
            keep_t):
    """The kernel: ``(loss, flat)``, ``flat`` the five gradients one after
    another."""
    global launches
    nc, s, d = phs.shape
    c = cand_h.shape[1]
    dev = phs.device
    ins = [None if x is None else x.contiguous()
           for x in (phs, prs, pts, cand_h, cand_t, pos_mask, keep_h, keep_t)]
    rows, pools = nc * s * d, nc * c * d
    tiles = -(-s // _ROWS)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    flat = torch.empty(3 * rows + 2 * pools, dtype=torch.float32,
                       device=dev)
    if nc * s == 0:
        return loss.zero_(), flat.zero_()
    # scratch: the blocks' loss partials (float64), then the pool gradients
    # of each row tile
    scratch = torch.empty(2 * nc * tiles + nc * tiles * 2 * c * d,
                          dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
    g = flat.data_ptr()
    outs = [g + 4 * off for off in (0, rows, 2 * rows, 3 * rows,
                                    3 * rows + pools)]
    part = scratch.data_ptr() + 8 * nc * tiles
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.chunk_loss(*(ptr(x) for x in ins), float(neg_weight), nc,
                             s, c, d, *outs, part, scratch.data_ptr(),
                             loss.data_ptr(), stream)
    _build.check(err, "chunk_loss")
    launches += 1
    count("loss.chunk_pairs", nc * s * 2 * c)
    return loss, flat


class _ChunkLoss(torch.autograd.Function):
    """The loss, with the gradients computed in the forward and scaled by
    the incoming gradient in the backward."""

    @staticmethod
    def forward(ctx, phs, prs, pts, cand_h, cand_t, neg_weight, pos_mask,
                keep_h, keep_t):
        args = (phs, prs, pts, cand_h, cand_t, neg_weight, pos_mask, keep_h,
                keep_t)
        if phs.device.type == "cpu":
            loss, grads = chunk_shared_loss_plain(*args)
            flat = torch.cat([g.reshape(-1) for g in grads])
        else:
            loss, flat = _launch(*args)
        ctx.flat = flat
        ctx.shapes = [x.shape for x in (phs, prs, pts, cand_h, cand_t)]
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_loss):
        flat, shapes = ctx.flat, ctx.shapes
        del ctx.flat
        parts = (flat * grad_loss).split([s.numel() for s in shapes])
        return (*(p.view(s) for p, s in zip(parts, shapes)),
                None, None, None, None)


def chunk_shared_loss(phs, prs, pts, cand_h, cand_t, neg_weight=1.0,
                      pos_mask=None, keep_h=None, keep_t=None):
    """The loss (a 0-dim tensor) of NC chunks; differentiable with respect
    to the five row tensors. Its gradients are always computed with it; with
    none wanted (under ``torch.no_grad()``, or no input requiring one) they
    are dropped, and the loss is the same, bit for bit."""
    _check(phs, prs, pts, cand_h, cand_t, pos_mask, keep_h, keep_t)
    if phs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {phs.device}")
    return _ChunkLoss.apply(phs, prs, pts, cand_h, cand_t, neg_weight,
                            pos_mask, keep_h, keep_t)
