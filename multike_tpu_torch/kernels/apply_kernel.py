"""Fused row-sparse Adagrad apply (K1): the CUDA kernel in
``csrc/apply_kernel.cu`` and its plain PyTorch version.

Replaces multike_tpu/kernels/apply_kernel.py::fused_row_adagrad_pallas. For
each row ``r = loc[k]`` inside the table: ``acc[r] += g^2`` then
``param[r] -= lr * g * where(acc[r] > 0, rsqrt(acc[r] + eps), 0)`` with
``g = gsum[k]``; slots outside the table are sentinels and dropped. ``loc``
must hold each row at most once (``train/sparse_adagrad.row_apply``
deduplicates). ``param`` and ``acc`` are updated in place.

:func:`fused_row_adagrad` follows its tensors' device: on the CPU it runs
the plain version, on a CUDA device it launches the kernel (or raises).
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from multike_tpu_torch.kernels import _build

launches = 0


def fused_row_adagrad_plain(param, acc, loc, gsum, lr: float,
                            eps: float = 1e-7):
    """Plain PyTorch version of the kernel (same operation order)."""
    valid = (loc >= 0) & (loc < param.shape[0])
    rows = loc[valid].long()
    g = gsum[valid]
    new_acc = acc[rows] + g * g
    upd = torch.where(new_acc > 0, torch.rsqrt(new_acc + eps), 0.0) * g
    acc[rows] = new_acc
    param[rows] = param[rows] - lr * upd
    return param, acc


def _check(param, acc, loc, gsum):
    if param.dtype != torch.float32 or acc.dtype != torch.float32 \
            or gsum.dtype != torch.float32:
        raise TypeError("param, acc and gsum must be float32")
    if loc.dtype != torch.int32:
        raise TypeError(f"loc must be int32, got {loc.dtype}")
    if param.dim() != 2 or param.shape != acc.shape:
        raise ValueError(f"param {tuple(param.shape)} and acc "
                         f"{tuple(acc.shape)} must be one (rows, d) shape")
    if loc.dim() != 1 or gsum.shape != (loc.shape[0], param.shape[1]):
        raise ValueError(f"loc {tuple(loc.shape)} / gsum "
                         f"{tuple(gsum.shape)} do not match (n,) / (n, d)")
    for name, t in (("param", param), ("acc", acc), ("loc", loc),
                    ("gsum", gsum)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != param.device:
            raise ValueError(f"{name} is on {t.device}, param on "
                             f"{param.device}")


def fused_row_adagrad(param, acc, loc, gsum, lr: float, eps: float = 1e-7):
    """One fused Adagrad step on rows ``loc`` of ``param``/``acc``, in
    place. Returns ``(param, acc)``."""
    global launches
    if param.device.type == "cpu":
        return fused_row_adagrad_plain(param, acc, loc, gsum, lr, eps)
    if param.device.type != "cuda":
        raise ValueError(f"unsupported device {param.device}")
    _check(param, acc, loc, gsum)
    lib = _build.load()
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_row_adagrad(
            param.data_ptr(), acc.data_ptr(), loc.data_ptr(), gsum.data_ptr(),
            loc.shape[0], param.shape[0], param.shape[1], lr, eps, stream)
    _build.check(err, "fused_row_adagrad")
    launches += 1
    return param, acc
