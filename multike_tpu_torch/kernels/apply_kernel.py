"""Row-sparse Adagrad apply (K1): the CUDA kernel in ``csrc/apply_kernel.cu``
and its plain PyTorch version.

Replaces multike_tpu/kernels/apply_kernel.py::fused_row_adagrad_pallas with
the sort and segment-sum that feed it in multike_tpu/train/sparse_adagrad.py
(``row_apply(..., use_pallas=True)``). For every row ``r`` in
``[row_offset, row_offset + rows)`` that ``ids`` touches, with ``g`` the sum
of its occurrences' rows of ``g_rows``: ``acc[r] += g^2`` then
``param[r] -= lr * where(acc[r] > 0, rsqrt(acc[r] + eps), 0) * g``. Ids
outside the range do nothing. ``param`` and ``acc`` are updated in place.

:func:`row_adagrad` follows its tensors' device: on the CPU it runs the
plain version (:func:`row_adagrad_plain`: a stable sort, a sequential
``index_add_`` and the update); on a CUDA device it
launches the kernel (or raises), which sums each row's occurrences in the
same order and so gives the same bits. ``launches`` counts the kernel's
launches, one per call. While a profiler session runs, each call adds its
ids to the tracer's counter ``apply.ids`` and the distinct rows they touch
to ``apply.unique`` (on the card a device scalar, the kernel's own count).

The kernel keeps int32 scratch per (device, stream), grown to the largest
table and step seen: two words for each table row, of which the counters
are zero between calls (the kernel restores them), and six for each id.
Calls on one stream are ordered, so they share it.
"""
from __future__ import annotations

import torch

from multike_tpu_torch.kernels import _build
from multike_tpu_torch.utils.profiling import count, recording

launches = 0
_COUNTERS = 8            # >= kNumCounters in csrc/apply_kernel.cu
_SLOTS = 3               # kSlots: the rows the last call touched
_scratch = {}            # (device index, stream) -> (counts, row_start, work)


def row_adagrad_plain(param, acc, ids, g_rows, lr: float, eps: float = 1e-7,
                      row_offset: int = 0):
    """Plain PyTorch version of the kernel, in place: a stable sort of
    ``ids``, a sequential ``index_add_`` of each row's occurrences in
    ascending order (the order in which the kernel sums them), then the
    update on the rows inside ``[row_offset, row_offset + rows)``."""
    sid, order = torch.sort(ids, stable=True)
    uniq, seg = torch.unique_consecutive(sid, return_inverse=True)
    gsum = g_rows.new_zeros((uniq.shape[0], g_rows.shape[1])).index_add_(
        0, seg, g_rows[order])
    loc = uniq - row_offset
    inside = (loc >= 0) & (loc < param.shape[0])
    rows, g = loc[inside], gsum[inside]
    new_acc = acc[rows] + g * g
    upd = torch.where(new_acc > 0, torch.rsqrt(new_acc + eps), 0.0) * g
    acc[rows] = new_acc
    param[rows] = param[rows] - lr * upd
    return param, acc


def _check(param, acc, ids, g_rows):
    if param.dtype != torch.float32 or acc.dtype != torch.float32 \
            or g_rows.dtype != torch.float32:
        raise TypeError("param, acc and g_rows must be float32")
    if ids.dtype != torch.int64:
        raise TypeError(f"ids must be int64, got {ids.dtype}")
    if param.dim() != 2 or param.shape != acc.shape:
        raise ValueError(f"param {tuple(param.shape)} and acc "
                         f"{tuple(acc.shape)} must be one (rows, d) shape")
    if ids.dim() != 1 or g_rows.shape != (ids.shape[0], param.shape[1]):
        raise ValueError(f"ids {tuple(ids.shape)} / g_rows "
                         f"{tuple(g_rows.shape)} do not match (n,) / (n, d)")
    for name, t in (("acc", acc), ("ids", ids), ("g_rows", g_rows)):
        if t.device != param.device:
            raise ValueError(f"{name} is on {t.device}, param on "
                             f"{param.device}")


def _scratch_for(device, stream: int, rows: int, n: int):
    """The kernel's scratch on ``stream`` for ``rows`` rows and ``n`` ids."""
    key = (device.index, stream)
    have = _scratch.get(key)
    if have is None or have[1].shape[0] < rows:
        have = (torch.zeros(_COUNTERS + rows, dtype=torch.int32,
                            device=device),
                torch.empty(rows, dtype=torch.int32, device=device),
                have[2] if have else torch.empty(0, dtype=torch.int32,
                                                 device=device))
    if have[2].shape[0] < 6 * n:
        have = have[:2] + (torch.empty(6 * n, dtype=torch.int32,
                                       device=device),)
    _scratch[key] = have
    return have


def row_adagrad(param, acc, ids, g_rows, lr: float, eps: float = 1e-7,
                row_offset: int = 0):
    """One Adagrad step on the rows of ``param``/``acc`` (a table of rows
    ``[row_offset, row_offset + rows)``) that ``ids`` touches, with the
    per-occurrence gradients ``g_rows``, in place. Returns ``(param,
    acc)``."""
    global launches
    _check(param, acc, ids, g_rows)
    if param.device.type == "cpu":
        if recording():
            inside = (ids >= row_offset) & (ids < row_offset + param.shape[0])
            count("apply.ids", ids.shape[0])
            count("apply.unique", torch.unique(ids[inside]).numel())
        return row_adagrad_plain(param, acc, ids, g_rows, lr, eps, row_offset)
    if param.device.type != "cuda":
        raise ValueError(f"unsupported device {param.device}")
    for name, t in (("param", param), ("acc", acc)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: it is updated "
                             "in place")
    g_rows = g_rows.contiguous()     # a no-op for autograd's rows
    n, (rows, d) = ids.shape[0], param.shape
    if n >= 2 ** 31 or rows >= 2 ** 31:
        raise ValueError(f"{n} ids into {rows} rows: the kernel counts in "
                         "int32")
    if n == 0 or rows == 0 or d == 0:
        return param, acc
    lib = _build.load()
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream().cuda_stream
        counts, row_start, work = _scratch_for(param.device, stream, rows, n)
        err = lib.row_adagrad(
            param.data_ptr(), acc.data_ptr(), ids.data_ptr(), ids.stride(0),
            g_rows.data_ptr(), n, row_offset, rows, d, lr, eps,
            counts.data_ptr(), row_start.data_ptr(), work.data_ptr(),
            stream)
    if err != 0:                   # the counters may no longer be zero
        _scratch.pop((param.device.index, stream), None)
    _build.check(err, "row_adagrad")
    launches += 1
    if recording():
        # a copy: the next call overwrites the kernel's count
        count("apply.ids", n)
        count("apply.unique", counts[_SLOTS].clone())
    return param, acc
