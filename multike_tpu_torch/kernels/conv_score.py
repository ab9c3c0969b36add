"""The attribute views' CNN scorer with its closed-form backward (K4): the
CUDA kernels in ``csrc/conv_score_kernel.cu`` and their plain PyTorch
version.

K4 replaces no TPU kernel: the JAX package's scorer
(multike_tpu/views/attr_conv.py) is ``lax.conv`` and ``jnp``, which XLA
fuses. Run eagerly on the card, the same expression is about 40 ops (two
cuDNN convolutions with their layout transposes) and about 40 autograd
nodes a step. Here one autograd ``Function`` computes the scores and, in
its backward, the gradients with respect to every parameter of the scorer
and to the head, attribute and value rows, in closed form:

  1. ``x0 = gamma * x * rsqrt(1 + 1e-3) + beta`` over the (2, d) image of
     a row's attribute and value;
  2. two convolutions with TF's SAME padding (``pad``, as ``F.pad`` takes
     it) and tanh: ``c_i = tanh(conv(c_{i-1}) + b_i)``;
  3. ``l = c * q`` with ``q = rsqrt(max(sum_w c^2, EPS_L2))`` over the
     width, per map and image row;
  4. ``t = tanh(flat(l) @ W + b)`` (flattened in (H, W, C) order), ``y = t
     * mask``;
  5. ``g = y * r`` with ``r = rsqrt(max(S, EPS_L2))``, ``S = sum y^2`` over
     the whole batch (over every rank's part, through ``batch_sum``);
  6. ``score = -|h - g|^2``.

Backward, from the incoming gradient ``gs`` of the scores: ``dh = -2 gs (h
- g)``; with ``T = sum <2 gs (h - g), g>`` (summed by ``batch_sum`` too),
``dy = r (2 gs (h - g) - T g)`` (``r 2 gs (h - g)`` where ``S < EPS_L2``,
as the clamp passes no gradient); ``dz = dy mask (1 - t^2)``; ``dW = flat^T
dz``, ``dflat = dz W^T``; through the norm ``dc = q (dl - l <dl, l>_w)``
(``q dl`` where the clamp holds), the convolutions' adjoints and the batch
norm.

The tensors' device picks the path: on the CPU the plain version
(:func:`conv_score_plain`, any padding and layer count); on a CUDA device
the kernels, which take the drivers' scorer (two layers of 2 maps, kernel
(2, 4), TF's SAME padding) at any width up to :data:`MAX_DIM`, or an error.
``launches`` counts the forward launches, and each adds its rows to the
``conv.kernel_rows`` counter while a profiler session runs, so a trace of
the card shows that every scored row ran the kernels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from multike_tpu_torch.kernels import _build
from multike_tpu_torch.params import EPS_L2
from multike_tpu_torch.utils.profiling import count

BN_EPS = 1e-3            # tf.layers.batch_normalization default epsilon
TF_SAME_PAD = (1, 2, 0, 1)   # F.pad order: TF's SAME for a (2, 4) kernel
MAX_DIM = 480            # the widest row whose buffers fit a block
_ROWS = 32               # = kRows in csrc/conv_score_kernel.cu
_TILE_M, _TILE_N, _KT = 32, 80, 32   # the weight gradient's tiles
_TARGET_BLOCKS = 264     # two blocks for each SM of an H100
# the small gradients, in the kernels' order: name -> (offset, shape)
_SMALL = {"conv0_w": (0, (2, 4, 1, 2)), "conv0_b": (16, (2,)),
          "conv1_w": (18, (2, 4, 2, 2)), "conv1_b": (50, (2,))}
_NCONV = 52

launches = 0


def _bn_inv(dtype) -> torch.Tensor:
    return torch.rsqrt(torch.tensor(1.0 + BN_EPS, dtype=dtype))


def _taps(x, w, b, pad):
    """TF's conv2d with stride 1: ``x`` (B, Ci, H, W), HWIO weights ``w``,
    padded by ``pad`` (F.pad order), as a sum over the kernel's taps."""
    kh, kw = w.shape[:2]
    xp = F.pad(x, pad)
    ho, wo = xp.shape[2] - kh + 1, xp.shape[3] - kw + 1
    out = b[None, :, None, None].expand(x.shape[0], -1, ho, wo)
    for i in range(kh):
        for j in range(kw):
            out = out + torch.einsum("bchw,co->bohw",
                                     xp[:, :, i:i + ho, j:j + wo], w[i, j])
    return out


def _taps_adjoint(x, du, w, pad):
    """The gradients of :func:`_taps` at ``x`` for the output gradient
    ``du``: ``(dx, dw, db)``."""
    kh, kw = w.shape[:2]
    xp = F.pad(x, pad)
    ho, wo = du.shape[2:]
    dxp = torch.zeros_like(xp)
    dw = torch.empty_like(w)
    for i in range(kh):
        for j in range(kw):
            dxp[:, :, i:i + ho, j:j + wo] += torch.einsum("bohw,co->bchw",
                                                          du, w[i, j])
            dw[i, j] = torch.einsum("bchw,bohw->co",
                                    xp[:, :, i:i + ho, j:j + wo], du)
    left, top = pad[0], pad[2]
    dx = dxp[:, :, top:top + x.shape[2], left:left + x.shape[3]]
    return dx, dw, du.sum(dim=(0, 2, 3))


def conv_score_plain(conv_params, attr_hs, attr_as, attr_vs, mask=None,
                     batch_sum=None, layer_num: int = 2, pad=TF_SAME_PAD):
    """``(scores, backward)``: the (B,) scores and a function that maps
    their incoming gradient to a dict of the gradients, in closed form,
    with respect to ``attr_hs``, ``attr_as``, ``attr_vs`` (keys ``h``,
    ``a``, ``v``) and every entry of ``conv_params``. ``batch_sum`` sums a
    scalar over the ranks that hold the other parts of the batch: ``S`` in
    the forward, ``T`` in the backward."""
    p = conv_params
    B, d = attr_hs.shape
    inv = _bn_inv(attr_hs.dtype)
    x = torch.stack([attr_as, attr_vs], dim=1)[:, None]     # (B, 1, 2, d)
    x0 = p["bn_gamma"] * x * inv + p["bn_beta"]
    cs = [x0]
    for i in range(layer_num):
        cs.append(torch.tanh(_taps(cs[-1], p[f"conv{i}_w"], p[f"conv{i}_b"],
                                   pad)))
    c = cs[-1]                                              # (B, C, 2, d)
    n = torch.sum(torch.square(c), dim=3, keepdim=True)
    q = torch.rsqrt(torch.clamp_min(n, EPS_L2))
    l = c * q
    flat = l.permute(0, 2, 3, 1).reshape(B, -1)             # (H, W, C)
    t = torch.tanh(flat @ p["dense_w"] + p["dense_b"])
    m = None if mask is None else mask.to(t.dtype)[:, None]
    y = t if m is None else t * m
    S = torch.sum(torch.square(y))
    if batch_sum is not None:
        S = batch_sum(S)
    r = torch.rsqrt(torch.clamp_min(S, EPS_L2))
    g = y * r
    diff = attr_hs - g
    scores = -torch.sum(torch.square(diff), dim=1)

    def backward(grad_scores):
        gs = grad_scores[:, None]
        gg = 2.0 * gs * diff
        T = torch.sum(gg * g)
        if batch_sum is not None:
            T = batch_sum(T)
        dy = r * (gg - T * g) if S >= EPS_L2 else r * gg
        dt = dy if m is None else dy * m
        dz = dt * (1.0 - torch.square(t))
        out = {"h": -gg, "dense_w": flat.T @ dz, "dense_b": dz.sum(dim=0)}
        dl = (dz @ p["dense_w"].T).reshape(B, 2, d, -1).permute(0, 3, 1, 2)
        dot = torch.sum(dl * l, dim=3, keepdim=True)
        dc = torch.where(n >= EPS_L2, q * (dl - l * dot), q * dl)
        for i in reversed(range(layer_num)):
            du = dc * (1.0 - torch.square(cs[i + 1]))
            dc, out[f"conv{i}_w"], out[f"conv{i}_b"] = _taps_adjoint(
                cs[i], du, p[f"conv{i}_w"], pad)
        out["bn_gamma"] = torch.sum(dc * x, dim=(0, 1, 2)) * inv
        out["bn_beta"] = torch.sum(dc, dim=(0, 1, 2))
        dx = dc * p["bn_gamma"] * inv
        out["a"], out["v"] = dx[:, 0, 0], dx[:, 0, 1]
        return out

    return scores, backward


def _check(p, hs, as_, vs, mask, layer_num, pad):
    """Raises for what the kernels do not take."""
    B, d = hs.shape if hs.dim() == 2 else (None, None)
    want = {"attr_as": (B, d), "attr_vs": (B, d), "mask": (B,),
            "bn_gamma": (d,), "bn_beta": (d,), "conv0_w": (2, 4, 1, 2),
            "conv0_b": (2,), "conv1_w": (2, 4, 2, 2), "conv1_b": (2,),
            "dense_w": (4 * d if d else None, d), "dense_b": (d,)}
    got = {"attr_as": as_, "attr_vs": vs, "mask": mask, **p}
    if layer_num != 2 or set(p) != set(want) - {"attr_as", "attr_vs",
                                                "mask"}:
        raise ValueError(f"the kernels take two convolutions of 2 maps, "
                         f"not layer_num={layer_num} with {sorted(p)}")
    if tuple(pad) != TF_SAME_PAD:
        raise ValueError(f"the kernels pad as TF's SAME, {TF_SAME_PAD}, "
                         f"not {tuple(pad)}")
    if B is None or not 0 < d <= MAX_DIM or B == 0:
        raise ValueError(f"rows {tuple(hs.shape)}: the kernels take (B, d) "
                         f"with B > 0 and 0 < d <= {MAX_DIM}")
    for name, x in {"attr_hs": hs, **got}.items():
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != hs.device:
            raise ValueError(f"{name} is on {x.device}, attr_hs on "
                             f"{hs.device}")
        if name != "attr_hs" and tuple(x.shape) != want[name]:
            raise ValueError(f"{name} {tuple(x.shape)} is not {want[name]} "
                             f"(attr_hs {tuple(hs.shape)})")


def wgrad_split(B: int, d: int):
    """``(splits, rows)``: the weight gradient's rows cut into ``splits``
    runs of ``rows`` (a multiple of the kernel's stage), so that its tiles
    times the splits come near two blocks an SM."""
    tiles = math.ceil(4 * d / _TILE_M) * math.ceil(d / _TILE_N)
    splits = max(1, min(math.ceil(B / _KT), math.ceil(_TARGET_BLOCKS / tiles)))
    rows = _KT * math.ceil(math.ceil(B / splits) / _KT)
    return math.ceil(B / rows), rows


def _launch_forward(p, hs, as_, vs, mask, batch_sum):
    """The kernels' forward: ``(scores, backward)`` as
    :func:`conv_score_plain` returns them."""
    global launches
    B, d = hs.shape
    dev = hs.device
    hs, as_, vs = hs.contiguous(), as_.contiguous(), vs.contiguous()
    p = {k: v.contiguous() for k, v in p.items()}
    mask = None if mask is None else mask.contiguous()
    # the convolutions' 52 weights and biases, in the kernels' order
    small_w = torch.cat([p[k].reshape(-1) for k in _SMALL])
    inv = float(_bn_inv(torch.float32))
    blocks = -(-B // _ROWS)
    flat = torch.empty(B, 4 * d, dtype=torch.float32, device=dev)
    t = torch.empty(B, d, dtype=torch.float32, device=dev)
    s_part = torch.empty(blocks, dtype=torch.float32, device=dev)
    S = torch.empty((), dtype=torch.float32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    scores = torch.empty(B, dtype=torch.float32, device=dev)
    hg = torch.empty(B, dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.conv_score_rows(
            as_.data_ptr(), vs.data_ptr(), ptr(mask),
            p["bn_gamma"].data_ptr(), p["bn_beta"].data_ptr(),
            small_w.data_ptr(), p["dense_w"].data_ptr(),
            p["dense_b"].data_ptr(), inv, B, d, flat.data_ptr(),
            t.data_ptr(), s_part.data_ptr(), ticket.data_ptr(),
            S.data_ptr(), stream), "conv_score_rows")
        if batch_sum is not None:
            S = batch_sum(S).contiguous()
        _build.check(lib.conv_score_out(
            hs.data_ptr(), t.data_ptr(), ptr(mask), S.data_ptr(), B, d,
            scores.data_ptr(), hg.data_ptr(), stream), "conv_score_out")
    launches += 1
    count("conv.kernel_rows", B)

    def backward(grad_scores):
        gs = grad_scores.contiguous()
        T = torch.empty((), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(lib.conv_score_t(gs.data_ptr(), hg.data_ptr(), B,
                                          T.data_ptr(), stream),
                         "conv_score_t")
        T_all = T if batch_sum is None else batch_sum(T).contiguous()
        splits, split_rows = wgrad_split(B, d)
        small = _NCONV + 3 * d
        dh, da, dv = (torch.empty_like(x) for x in (hs, as_, vs))
        dz = torch.empty_like(t)
        dflat = torch.empty_like(flat)
        part = torch.empty(blocks, small, dtype=torch.float32, device=dev)
        wpart = torch.empty(splits, 4 * d, d, dtype=torch.float32,
                            device=dev)
        sums = torch.empty(small, dtype=torch.float32, device=dev)
        dw = torch.empty_like(p["dense_w"])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(lib.conv_score_backward(
                hs.data_ptr(), as_.data_ptr(), vs.data_ptr(), ptr(mask),
                p["bn_gamma"].data_ptr(), p["bn_beta"].data_ptr(),
                small_w.data_ptr(), p["dense_w"].data_ptr(), inv, B, d,
                t.data_ptr(), flat.data_ptr(), S.data_ptr(), gs.data_ptr(),
                T_all.data_ptr(), splits, split_rows, dh.data_ptr(),
                da.data_ptr(), dv.data_ptr(), dz.data_ptr(), dflat.data_ptr(),
                part.data_ptr(), wpart.data_ptr(), sums.data_ptr(),
                dw.data_ptr(), stream), "conv_score_backward")
        out = {"h": dh, "a": da, "v": dv, "dense_w": dw,
               "bn_gamma": sums[_NCONV:_NCONV + d],
               "bn_beta": sums[_NCONV + d:_NCONV + 2 * d],
               "dense_b": sums[_NCONV + 2 * d:]}
        for name, (off, shape) in _SMALL.items():
            out[name] = sums[off:off + math.prod(shape)].view(shape)
        return out

    return scores, backward


class _ConvScore(torch.autograd.Function):
    """The scores; the backward hands autograd the closed-form gradients
    of the inputs that need one."""

    @staticmethod
    def forward(ctx, names, batch_sum, layer_num, pad, mask, hs, as_, vs,
                *leaves):
        p = dict(zip(names, leaves))
        if hs.device.type == "cpu":
            scores, ctx.backward_fn = conv_score_plain(
                p, hs, as_, vs, mask, batch_sum, layer_num, pad)
        else:
            scores, ctx.backward_fn = _launch_forward(p, hs, as_, vs, mask,
                                                      batch_sum)
        ctx.names = names
        return scores

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_scores):
        g = ctx.backward_fn(grad_scores)
        del ctx.backward_fn
        keys = ("h", "a", "v") + ctx.names
        return (None,) * 5 + tuple(
            g[k] if want else None
            for k, want in zip(keys, ctx.needs_input_grad[5:]))


def scores(conv_params, attr_hs, attr_as, attr_vs, mask=None,
           batch_sum=None, layer_num: int = 2, pad=TF_SAME_PAD):
    """(B,) scores of the scorer ``conv_params`` (the JAX package's HWIO
    layout), differentiable with respect to the three row tensors and every
    parameter; see the module docstring."""
    dev = attr_hs.device.type
    if dev == "cuda":
        _check(conv_params, attr_hs, attr_as, attr_vs, mask, layer_num, pad)
    elif dev != "cpu":
        raise ValueError(f"unsupported device {attr_hs.device}")
    names = tuple(conv_params)
    return _ConvScore.apply(names, batch_sum, layer_num, tuple(pad), mask,
                            attr_hs, attr_as, attr_vs,
                            *(conv_params[k] for k in names))
