"""Faults planted in the program's timed path, to show that ``correct``
catches them (``readings.py --fault``, and the CPU tests):

  * ``state_unchanged``: the optimizer's apply does nothing, so a step
    returns its state unchanged;
  * ``half_batch``: the loss sees the first half of the positives only and
    doubles it, the mean taken over the rest;
  * ``draw_altered``: the first candidate each draw makes is moved out of
    its KG, altered where it is produced.

A cell runs on one card, so there is no exchange between cards to leave
out.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

FAULTS = {"rel_view": ("state_unchanged", "half_batch", "draw_altered")}


@contextlib.contextmanager
def planted(fault: str, per_slot: bool):
    from multike_tpu_torch.train import sparse_adagrad, streams

    if fault == "state_unchanged":
        target, name = sparse_adagrad, "dense_apply"
        new = lambda param, acc, grads, lr, eps=0: (param, acc)  # noqa: E731
    elif fault == "half_batch":
        target = streams
        name = "lean_relation_logistic_loss" if per_slot else \
            "chunk_shared_relation_logistic_loss"
        loss = getattr(streams, name)

        def cut(a):
            # the first half of the positives: axis 1 of a chunked tensor
            if not torch.is_tensor(a):
                return a
            return a[:a.shape[0] // 2] if per_slot else a[:, :a.shape[1] // 2]

        def new(*args, **kw):
            args = [cut(a) if per_slot or i < 3 else a
                    for i, a in enumerate(args)]
            return 2.0 * loss(*args, **{k: cut(v) for k, v in kw.items()})
    elif fault == "draw_altered":
        target = streams
        name = "sample_corruptions" if per_slot else \
            "sample_shared_corruptions"
        draw = getattr(streams, name)

        def new(*args, **kw):
            lo, hi = args[2:4] if per_slot else args[3:5]
            out = list(draw(*args, **kw))
            out[0] = out[0].clone()
            out[0].view(-1)[0] = lo - 1 if lo > 0 else hi
            return tuple(out)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    with mock.patch.object(target, name, new):
        yield
