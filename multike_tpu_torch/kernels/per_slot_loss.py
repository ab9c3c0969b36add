"""Per-slot TransE logistic loss (K5): the CUDA kernel in
``csrc/per_slot_loss_kernel.cu`` and its plain PyTorch version.

K5 replaces no TPU kernel: the JAX package's
multike_tpu/losses.py::lean_relation_logistic_loss is plain jnp, which XLA
fuses. Run eagerly, the same expression is some 20 ops a KG and as many
autograd nodes, each a pass over the step's (B, K) or (B, K, D) tensors,
which set the per-slot relation view's card time. :func:`per_slot_loss`
computes the loss and, in the same pass, its gradients with respect to the
four row tensors; an autograd ``Function`` hands them to autograd scaled by
the incoming gradient (one elementwise op over one flat buffer). The
kernel is bound by bytes: every row read once and its gradient written
once (csrc/per_slot_loss_kernel.cu says how its design meets that).

With ``phs/prs/pts`` (B, D), ``cand_rows`` (B, K, D), ``corrupt_head``
(B, K) bool, the positives' mask ``pos_mask`` (B,) and the slots'
``neg_keep`` (B, K), the last two optional::

    loss = sum m softplus(|h + r - t|^2)
         + sum m keep softplus(-|c + r - t|^2)    where the coin is head
         + sum m keep softplus(-|h + r - c|^2)    where the coin is tail

The tensors' device picks the path: on the CPU the plain version
(:func:`per_slot_loss_plain`: the closed-form loss and gradients); on a
CUDA device the kernel, or an error. ``launches`` counts the calls that
launched it. Each call adds its slots, B x K, to the ``loss.slot_pairs``
counter while a profiler session runs: a CUDA call always launches the
kernel, so a trace of the card shows that every per-slot step ran it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from multike_tpu_torch.kernels import _build
from multike_tpu_torch.utils.profiling import count

launches = 0
_WARPS = 8               # = kWarps in csrc/per_slot_loss_kernel.cu
# a block keeps each of its 8 positives' K slot coefficients in shared
# memory, at most 227 KB
_MAX_SLOTS = 232_448 // (4 * _WARPS)


def _sq_norm(x):
    return torch.sum(torch.square(x), dim=-1)


def per_slot_loss_plain(phs, prs, pts, cand_rows, corrupt_head,
                        pos_mask=None, neg_keep=None):
    """``(loss, grads)``: the loss and its gradients with respect to
    ``(phs, prs, pts, cand_rows)`` in closed form. With x = c + r - t for a
    head slot and x = h + r - c for a tail slot, the slot's coefficient
    k = -2 m keep sigmoid(-|x|^2) gives k x to g_c and g_r and -k x to g_t
    (head) or k x to g_h and g_r and -k x to g_c (tail); the positive adds
    2 m sigmoid(|a|^2) a to g_h and g_r and subtracts it from g_t, with
    a = h + r - t."""
    a = phs + prs - pts
    sq = _sq_norm(a)                                                # (B,)
    m = torch.ones_like(sq) if pos_mask is None else pos_mask
    head = corrupt_head[..., None]
    x = torch.where(head, cand_rows + prs[:, None] - pts[:, None],
                    phs[:, None] + prs[:, None] - cand_rows)        # (B, K, D)
    dist = _sq_norm(x)                                              # (B, K)
    wk = m[:, None].expand_as(dist)
    if neg_keep is not None:
        wk = wk * neg_keep
    loss = torch.sum(F.softplus(sq) * m) + torch.sum(F.softplus(-dist) * wk)
    g_pos = (2.0 * m * torch.sigmoid(sq))[:, None] * a
    kx = (-2.0 * wk * torch.sigmoid(-dist))[..., None] * x
    zero = kx.new_zeros(())
    g_c = torch.where(head, kx, -kx)
    g_h = g_pos + torch.where(head, zero, kx).sum(1)
    g_r = g_pos + kx.sum(1)
    g_t = -g_pos - torch.where(head, kx, zero).sum(1)
    return loss, (g_h, g_r, g_t, g_c)


def _check(phs, prs, pts, cand_rows, corrupt_head, pos_mask, neg_keep):
    b, d = phs.shape if phs.dim() == 2 else (None,) * 2
    k = cand_rows.shape[1] if cand_rows.dim() == 3 else None
    want = {"phs": (b, d), "prs": (b, d), "pts": (b, d),
            "cand_rows": (b, k, d), "corrupt_head": (b, k),
            "pos_mask": (b,), "neg_keep": (b, k)}
    got = dict(phs=phs, prs=prs, pts=pts, cand_rows=cand_rows,
               corrupt_head=corrupt_head, pos_mask=pos_mask,
               neg_keep=neg_keep)
    for name, x in got.items():
        if x is None:
            continue
        dtype = torch.bool if name == "corrupt_head" else torch.float32
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != phs.device:
            raise ValueError(f"{name} is on {x.device}, phs on {phs.device}")
        if None in want[name] or tuple(x.shape) != want[name]:
            raise ValueError(f"{name} {tuple(x.shape)} does not match "
                             f"{want[name]} (phs {tuple(phs.shape)}, "
                             f"cand_rows {tuple(cand_rows.shape)})")
    if d == 0:
        raise ValueError("rows of width 0")
    if k > _MAX_SLOTS or b >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"{b} positives of {k} slots, {d} wide: the kernel "
                         f"takes at most {_MAX_SLOTS} slots a positive and "
                         "under 2**31 positives and columns")


def _launch(phs, prs, pts, cand_rows, corrupt_head, pos_mask, neg_keep):
    """The kernel: ``(loss, flat)``, ``flat`` the four gradients one after
    another."""
    global launches
    b, k, d = cand_rows.shape
    dev = phs.device
    ins = [None if x is None else x.contiguous()
           for x in (phs, prs, pts, cand_rows, corrupt_head, pos_mask,
                     neg_keep)]
    rows, slots = b * d, b * k * d
    loss = torch.empty((), dtype=torch.float32, device=dev)
    flat = torch.empty(3 * rows + slots, dtype=torch.float32, device=dev)
    loss_part = torch.empty(-(-b // _WARPS), dtype=torch.float64, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
    g = flat.data_ptr()
    outs = [g + 4 * off for off in (0, rows, 2 * rows, 3 * rows)]
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.per_slot_loss(*(ptr(x) for x in ins), b, k, d, *outs,
                                loss_part.data_ptr(), loss.data_ptr(), stream)
    _build.check(err, "per_slot_loss")
    launches += 1
    return loss, flat


class _SlotLoss(torch.autograd.Function):
    """The loss, with the gradients computed in the forward and scaled by
    the incoming gradient in the backward."""

    @staticmethod
    def forward(ctx, phs, prs, pts, cand_rows, corrupt_head, pos_mask,
                neg_keep):
        args = (phs, prs, pts, cand_rows, corrupt_head, pos_mask, neg_keep)
        if phs.device.type == "cpu":
            loss, grads = per_slot_loss_plain(*args)
            flat = torch.cat([g.reshape(-1) for g in grads])
        else:
            loss, flat = _launch(*args)
        count("loss.slot_pairs", corrupt_head.numel())
        ctx.flat = flat
        ctx.shapes = [x.shape for x in (phs, prs, pts, cand_rows)]
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_loss):
        flat, shapes = ctx.flat, ctx.shapes
        del ctx.flat
        parts = (flat * grad_loss).split([s.numel() for s in shapes])
        return (*(p.view(s) for p, s in zip(parts, shapes)),
                None, None, None)


def per_slot_loss(phs, prs, pts, cand_rows, corrupt_head, pos_mask=None,
                  neg_keep=None):
    """The loss (a 0-dim tensor) of B positives and their K slots each;
    differentiable with respect to the four row tensors. Its gradients are
    always computed with it; with none wanted (under ``torch.no_grad()``,
    or no input requiring one) they are dropped, and the loss is the same,
    bit for bit."""
    _check(phs, prs, pts, cand_rows, corrupt_head, pos_mask, neg_keep)
    if phs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {phs.device}")
    return _SlotLoss.apply(phs, prs, pts, cand_rows, corrupt_head, pos_mask,
                           neg_keep)
