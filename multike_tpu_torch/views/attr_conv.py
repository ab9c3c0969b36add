"""Attribute-view CNN scorer (counterpart of multike_tpu/views/attr_conv.py).

For a batch of (h, a, v) embeddings, each (B, dim):
  1. stack a and v into a (B, 2, dim, 1) image (NHWC, as the JAX package);
  2. batch norm over axis 2 in inference mode with moving statistics that
     are never updated (the reference's ``tf.layers.batch_normalization``
     defaults to ``training=False``): ``gamma * x / sqrt(1 + 1e-3) + beta``;
  3. two conv2d layers, 2 feature maps, kernel (2, 4), stride 1, TF 'SAME'
     padding, tanh. For even kernels TF pads more after than before:
     (0, 1) in height and (1, 2) in width, done with ``F.pad`` before a
     ``conv2d`` without padding. Weights are kept HWIO (``params.py``) and
     permuted to OIHW; activations run NCHW and come back NHWC;
  4. l2-normalize over axis 2;
  5. flatten (H, W, C order) -> dense(dim, tanh) -> l2-normalize over the
     WHOLE tensor, after zeroing the masked rows;
  6. score = -||h - dense||^2.

:func:`conv_stages` is that forward in plain PyTorch, every stage kept (the
tests compare it with the JAX package, which computes it with ``lax.conv``
outside any Pallas kernel). :func:`conv_score`, the streams' call, runs the
scorer as one autograd ``Function`` with a closed-form backward
(``kernels/conv_score.py``): the K4 kernels on the card, their plain version
on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from multike_tpu_torch.kernels import conv_score as k4
from multike_tpu_torch.params import l2_normalize
from multike_tpu_torch.utils.profiling import count, span

BN_EPS = k4.BN_EPS
SAME_PAD = k4.TF_SAME_PAD    # F.pad order: (left, right, top, bottom)


def conv_stages(conv_params, attr_hs, attr_as, attr_vs, layer_num: int = 2,
                mask=None, batch_sum=None):
    """Every intermediate activation of the scorer, NHWC, keyed as in the
    JAX package; :func:`conv_score` keeps only ``"score"``. ``batch_sum``:
    see :func:`conv_score`."""
    B = attr_hs.shape[0]
    stages = {}
    x = torch.stack([attr_as, attr_vs], dim=1)[..., None]   # (B, 2, dim, 1)
    stages["stack"] = x

    gamma = conv_params["bn_gamma"][None, None, :, None]
    beta = conv_params["bn_beta"][None, None, :, None]
    inv = torch.rsqrt(torch.tensor(1.0 + BN_EPS, dtype=x.dtype,
                                   device=x.device))
    x = gamma * x * inv + beta
    stages["bn"] = x

    x = x.permute(0, 3, 1, 2)                                # NCHW
    for i in range(layer_num):
        w = conv_params[f"conv{i}_w"].permute(3, 2, 0, 1)    # HWIO -> OIHW
        x = torch.tanh(F.conv2d(F.pad(x, SAME_PAD), w,
                                conv_params[f"conv{i}_b"]))
        stages[f"conv{i}"] = x.permute(0, 2, 3, 1)
    x = l2_normalize(x.permute(0, 2, 3, 1), axis=2)          # (B, 2, dim, C)
    stages["l2_axis2"] = x
    dense = torch.tanh(x.reshape(B, -1) @ conv_params["dense_w"]
                       + conv_params["dense_b"])
    stages["dense_tanh"] = dense
    if mask is not None:
        dense = dense * mask[:, None]
    dense = l2_normalize(dense, axis=None, batch_sum=batch_sum)  # global norm
    stages["dense_gnorm"] = dense
    stages["score"] = -torch.sum(torch.square(attr_hs - dense), dim=1)
    return stages


def conv_score(conv_params, attr_hs, attr_as, attr_vs, layer_num: int = 2,
               mask=None, batch_sum=None):
    """(B,) scores. ``mask`` (B,) zeroes padded rows before the whole-tensor
    normalization of step 5, so they do not change the real rows' values.
    ``batch_sum``: with the batch split over ranks, the differentiable sum
    over them that makes step 5's norm the whole batch's
    (``params.l2_normalize``). Its span is ``step.conv``, and it adds its
    rows to the tracer's counter ``conv.rows`` (and K4's launches theirs to
    ``conv.kernel_rows``)."""
    with span("step.conv"):
        count("conv.rows", attr_hs.shape[0])
        return k4.scores(conv_params, attr_hs, attr_as, attr_vs, mask=mask,
                         batch_sum=batch_sum, layer_num=layer_num,
                         pad=SAME_PAD)
