"""Multi-process execution over ``torch.distributed`` (counterpart of
multike_tpu/parallel/distributed.py).

One process per rank. :func:`init_distributed` joins the process group once,
before the mesh is built; with one process it does nothing. It reads the
JAX package's variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``) or torchrun's (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). The backend follows the rank's
device: NCCL for a CUDA device, gloo for the CPU; the caller may name
another, for example gloo to put several ranks on one card.

Every collective of the port goes through the wrappers here
(:func:`all_reduce`, :func:`all_gather`, :func:`ring_shift` and the
differentiable :func:`all_reduce_sum`). Gloo carries CUDA tensors in
all_reduce and broadcast only, not in all_gather or send/recv (PyTorch's
backend table), so over gloo every CUDA tensor is copied through the host,
in :func:`_run` alone; the first such copy is logged. NCCL never stages.
A collective's error propagates.

Host data is whole on every rank: each rank holds the complete triple
arrays and takes its block of each step's batch (``MeshContext.dp_block``),
because the batches come from one permutation drawn alike on every rank.
:func:`local_block` and :func:`full_copy` are the two placements the mesh
uses for tables: a rank's block of rows, or a full copy.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("multike_tpu_torch")

# collectives whose CUDA tensors were staged through the host (gloo only)
staged = 0


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``; 0 if
    unset)."""
    return _env_int("LOCAL_RANK") or 0


def rank_device(device=None) -> torch.device:
    """The rank's device: ``device`` if given, else ``cuda:LOCAL_RANK``."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", local_rank())


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     init_method: Optional[str] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group, once; a no-op with one process.

    World size and rank come from the arguments, else from ``NUM_PROCESSES``
    / ``PROCESS_ID`` or ``WORLD_SIZE`` / ``RANK``. The rendezvous is
    ``init_method`` (for example ``file:///shared/store``), else
    ``tcp://COORDINATOR_ADDRESS`` or ``tcp://MASTER_ADDR:MASTER_PORT``.
    ``backend``: "nccl" or "gloo"; by default NCCL when the rank's device
    (:func:`rank_device`) is a CUDA device, gloo otherwise."""
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE") or 1
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
        if process_id is None:
            raise RuntimeError("multi-process run without PROCESS_ID or RANK")
    if init_method is None:
        addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
        if addr is None:
            addr = (f"{os.environ['MASTER_ADDR']}:"
                    f"{os.environ['MASTER_PORT']}")
        init_method = addr if "://" in addr else f"tcp://{addr}"
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return world_size() > 1


def block_slice(n: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``n`` rows cut into ``parts`` contiguous blocks of
    ``ceil(n / parts)`` rows (the last ones may be short or empty)."""
    per = -(-n // parts)
    return slice(min(index * per, n), min((index + 1) * per, n))


def local_data_slice(n: int) -> slice:
    """This process's contiguous block of a length-``n`` list."""
    return block_slice(n, world_size(), rank())


def padded_rows_per_process(n: int) -> int:
    """``n`` rounded up so every process holds an equal block."""
    pc = world_size()
    return -(-n // pc) * pc


def local_block(x: torch.Tensor, parts: int, index: int,
                device=None) -> torch.Tensor:
    """Block ``index`` of ``x``'s rows cut into ``parts`` equal blocks (the
    row count must divide), as a contiguous tensor of its own."""
    if x.shape[0] % parts:
        raise ValueError(f"{x.shape[0]} rows do not split into {parts} "
                         "equal blocks")
    per = x.shape[0] // parts
    return x[index * per:(index + 1) * per].to(device or x.device,
                                                copy=True).contiguous()


def full_copy(x: torch.Tensor, device=None) -> torch.Tensor:
    """A rank's own copy of a replicated tensor."""
    return x.to(device or x.device, copy=True)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def transport(group=None) -> str:
    """How the group's collectives travel: "nccl", or "gloo" (CUDA tensors
    staged through the host)."""
    return dist.get_backend(group)


def _run(op, tensors, group):
    """Runs ``op(tensors)``, a ``torch.distributed`` call on the list
    ``tensors``. Over gloo, CUDA tensors travel as host copies, and the
    results are copied back; this is the only place that stages (counted in
    ``staged``, the first one logged)."""
    global staged
    if dist.get_backend(group) != "gloo" or not any(t.is_cuda
                                                    for t in tensors):
        op(tensors)
        return
    if staged == 0:
        log.warning("gloo backend: CUDA tensors are staged through the host "
                    "for every collective")
    staged += 1
    host = [t.cpu() for t in tensors]
    op(host)
    with torch.no_grad():
        for t, h in zip(tensors, host):
            if t.is_cuda:
                t.copy_(h)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the group, in place; returns ``t``."""
    _run(lambda ts: dist.all_reduce(ts[0], group=group), [t], group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along dim 0, in the
    group's rank order."""
    n = dist.get_world_size(group)
    outs = [torch.empty_like(t) for _ in range(n)]
    _run(lambda ts: dist.all_gather(ts[:n], ts[n], group=group),
         outs + [t.contiguous()], group)
    return torch.cat(outs)


def all_gather_ragged(tensors, group=None, sizes=None):
    """:func:`all_gather` of each of ``tensors``, which share a dim 0 that
    differs between ranks: ``sizes`` (each rank's dim 0, in group order)
    is gathered first unless the caller knows it."""
    n = dist.get_world_size(group)
    if sizes is None:
        size = torch.tensor([tensors[0].shape[0]], dtype=torch.int64,
                            device=tensors[0].device)
        sizes = all_gather(size, group).tolist()
    top = max(sizes)
    out = []
    for t in tensors:
        pad = top - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        blocks = all_gather(t, group).split(top)
        out.append(torch.cat([b[:s] for b, s in zip(blocks[:n], sizes)]))
    return out


def ring_shift(tensors, group=None):
    """Each rank sends ``tensors`` to the next rank of the group and returns
    those of the previous one (a ring rotation; identity for one rank)."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    k = len(tensors)

    def op(ts):
        ops = [dist.P2POp(dist.isend, t, nxt, group) for t in ts[:k]]
        ops += [dist.P2POp(dist.irecv, t, prv, group) for t in ts[k:]]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _run(op, [t.contiguous() for t in tensors] + recv, group)
    return recv


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group with a gradient: each rank's input gets the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group (every rank must run the
    backward pass too, in the same order)."""
    return _AllReduceSum.apply(x, group)
