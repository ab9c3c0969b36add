"""Traffic kind ``rel_view``: relation-view epochs of the port's epoch
callable, back to back, on a KG pair of random triples.

The mix file gives the pair's shape (``entities_per_kg``, ``triples`` and
``relations`` per KG), the ``phase`` ("uniform", or "truncated" with a
``neighbors`` table of ``useful_share`` and ``k``) and ``config``, the
Config keys the mix sets (the batch).

Set-up makes the triples, the tables and the truncated-sampling table from
the seed, then builds the epoch as ``MultiKETrainer._get_epoch_fn`` does
(``streams.build_rel_view_epoch`` with the trainer's Bloom filter over both
KGs' triples), with Adagrad accumulators from ``sparse_adagrad.init_acc``.
One epoch warms every shape; its first three steps, through the epoch's
own ``step``, are the steps the reference follows. The window runs whole
epochs, each ending as the trainer's does, by reading its loss.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from gpubench.lib import bounds, compare, data
from gpubench.reference import draws, transe

CHECKED_STEPS = 3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    def __init__(self, cfg, mix: dict, seed: int, device, rec):
        from multike_tpu_torch.sampling import (build_neighbor_state,
                                                build_triple_filter)
        from multike_tpu_torch.train import sparse_adagrad, streams

        self.cfg, self.mix, self.seed, self.device, self.rec = (
            cfg, mix, seed, device, rec)
        n = mix["entities_per_kg"]
        self.n_ent = 2 * n
        self.n_rel = sum(mix["relations"])
        self.ranges = ((0, n), (n, 2 * n))
        self.truncated = mix["phase"] == "truncated"
        self.tr = data.kg_pair_triples(seed, n, mix["triples"],
                                       mix["relations"])
        self.t1, self.t2 = (torch.as_tensor(t, device=device)
                            for t in self.tr)
        e0, r0 = data.relation_view_tables(seed, self.n_ent, self.n_rel,
                                           cfg.dim, device)
        self.params = {"rv_ent": e0.clone(), "rel": r0.clone()}
        self.opt = {k: sparse_adagrad.init_acc(v)
                    for k, v in self.params.items()}
        tfilter = None
        if cfg.neg_rejection_tries > 0 or cfg.chunk_exact_rejection:
            tfilter = build_triple_filter(np.concatenate(self.tr),
                                          device=device)
        self.neighbors = None
        if self.truncated:
            nb = mix["neighbors"]
            self.neighbors = build_neighbor_state(
                self.n_ent, data.neighbor_parts(seed, self.ranges,
                                                nb["useful_share"], nb["k"],
                                                device), device=device)
        self.epoch, self.steps, self.trained = streams.build_rel_view_epoch(
            cfg, len(self.tr[0]), len(self.tr[1]), self.ranges,
            with_neighbors=self.truncated, tfilter=tfilter)
        self.scheme = self.epoch.scheme
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(data.derived_seed(seed, data.SAMPLING))
        self.program = self._warm_up({"rv_ent": e0, "rel": r0})
        self.epoch_flops = self._epoch_flops()

    # ------------------------------------------------------------------
    def _run_epoch(self) -> float:
        return float(self.epoch(self.params, self.opt, self.gen, self.t1,
                                self.t2, self.neighbors))

    def _warm_up(self, initial: dict) -> dict:
        """One epoch through the epoch's own call; its first steps are
        recorded: their inputs, losses, the first gradient's norm per table
        (from the accumulators after step 1) and each table's change after
        the last checked step."""
        self.captured = []
        out = {"losses": []}
        acc0 = {k: v.clone() for k, v in self.opt.items()}
        step = self.epoch.step

        def checked(params, opt, *batch):
            i = len(self.captured)
            if i >= CHECKED_STEPS:
                return step(params, opt, *batch)
            self.captured.append(tuple(
                None if x is None else x.detach().cpu().clone()
                for x in batch))
            loss = step(params, opt, *batch)
            out["losses"].append(float(loss))
            if i == 0:
                out["grad_norms"] = {
                    k: float((opt[k].double() - acc0[k].double()).sum()
                             .sqrt()) for k in opt}
            if i == CHECKED_STEPS - 1:
                out["delta_norms"] = {
                    k: float((params[k].double() - initial[k].double())
                             .norm()) for k in params}
            return loss

        self.epoch.step = checked
        try:
            loss = self._run_epoch()
        finally:
            del self.epoch.step
        if not math.isfinite(loss):
            raise RuntimeError(f"the warm-up epoch's loss is {loss}")
        if len(self.captured) < CHECKED_STEPS:
            raise RuntimeError("an epoch has fewer steps than are checked")
        out["unique_rows"] = float(np.mean([self._unique_rows(b)
                                            for b in self.captured]))
        _sync(self.device)
        return out

    def _unique_rows(self, batch) -> int:
        """Distinct entity and relation rows a step's real positives and
        their negatives touch."""
        ents, rels = [], []
        for kg in self._split(batch):
            real = kg["mask"] > 0
            pos = kg["pos"][real]
            ents += [pos[:, 0], pos[:, 2]]
            rels.append(pos[:, 1])
            if self.scheme == "per_slot":
                ents.append(kg["cand"][real].reshape(-1))
            else:
                ents += [kg["ch"].reshape(-1), kg["ct"].reshape(-1)]
        return (int(torch.unique(torch.cat(ents)).numel())
                + int(torch.unique(torch.cat(rels)).numel()))

    def _split(self, batch):
        """A step's inputs as the reference takes them, per KG."""
        if self.scheme == "per_slot":
            keys = ("pos", "mask", "cand", "head", "keep")
            kgs = [dict(zip(keys, batch[:5])), dict(zip(keys, batch[5:]))]
            for kg in kgs:
                kg["head"] = kg["head"].bool()
        else:
            keys = ("pos", "mask", "ch", "ct")
            kgs = [dict(zip(keys, batch[:4])), dict(zip(keys, batch[4:]))]
        return kgs

    def _epoch_flops(self) -> float:
        cfg, trained = self.cfg, self.trained
        unique = self.steps * self.program["unique_rows"]
        if self.scheme == "per_slot":
            return bounds.per_slot_step_flops(cfg.dim, trained,
                                              cfg.neg_triple_num, unique)
        pool = cfg.truncated_pool_size if self.truncated else \
            cfg.neg_pool_size
        chunk = cfg.truncated_chunk_size if self.truncated else \
            cfg.neg_chunk_size
        chunks = sum(-(-bs // chunk) for bs in self._batch_sizes())
        return bounds.chunk_step_flops(cfg.dim, trained, self.steps * chunks,
                                       pool or cfg.neg_triple_num, unique)

    def _batch_sizes(self):
        """Each KG's share of a batch, in proportion to its triples."""
        n1, n2 = (len(t) for t in self.tr)
        bs1 = int(n1 / (n1 + n2) * self.cfg.batch_size)
        return bs1, self.cfg.batch_size - bs1

    # ------------------------------------------------------------------
    def trace_hooks(self):
        """Spans around the epoch's draw and step and the optimizer's
        applies, for a traced window."""
        from multike_tpu_torch.train import sparse_adagrad

        rec = self.rec
        self.epoch.draw = rec.wrap(self.epoch.draw, "draw")
        self.epoch.step = rec.wrap(self.epoch.step, "step")
        saved = sparse_adagrad.dense_apply, sparse_adagrad.row_apply
        sparse_adagrad.dense_apply = rec.wrap(saved[0], "apply")
        sparse_adagrad.row_apply = rec.wrap(saved[1], "apply")

        def undo():
            del self.epoch.draw, self.epoch.step
            sparse_adagrad.dense_apply, sparse_adagrad.row_apply = saved
        return ("draw", "step", "apply"), undo

    def window(self, seconds: float) -> dict:
        epochs = failed = 0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            loss = self._run_epoch()
            epochs += 1
            failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.rec.count("epochs", epochs)
        self.rec.count("steps", epochs * self.steps)
        self.rec.count("triples", epochs * self.trained)
        self.rec.count("model_flops", epochs * self.epoch_flops)
        return dict(window_s=elapsed, attempted=epochs, failed=failed,
                    metrics={"rel_triples_per_s":
                             self.trained * epochs / elapsed})

    def free(self):
        """Drops the program's state, before the reference runs."""
        for name in ("params", "opt", "neighbors", "epoch", "gen", "t1",
                     "t2"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def _reference_steps(self):
        dev = self.device
        steps = []
        for i, batch in enumerate(self.captured):
            kgs = self._split(tuple(None if x is None else x.to(dev)
                                    for x in batch))
            for kg, bs, n in zip(kgs, self._batch_sizes(),
                                 (len(t) for t in self.tr)):
                j = torch.arange(kg["pos"].shape[0], device=dev)
                kg["program_mask"] = kg["mask"]
                kg["mask"] = ((j < bs) & (i * bs + j < n)).float()
            steps.append(kgs)
        return steps

    def _draw_faults(self, steps) -> dict:
        bad_pos = bad_cand = keep_bad = 0
        true = draws.TrueTriples(np.concatenate(self.tr), self.n_ent,
                                 self.n_rel)
        bloom = draws.Bloom(np.concatenate(self.tr)) \
            if self.scheme == "per_slot" else None
        parts = None
        if self.truncated:
            nb = self.mix["neighbors"]
            parts = data.neighbor_parts(self.seed, self.ranges,
                                        nb["useful_share"], nb["k"],
                                        self.device)
        for kgs in steps:
            for kg, (lo, hi) in zip(kgs, self.ranges):
                real = kg["mask"] > 0
                bad_pos += int((kg["program_mask"] != kg["mask"]).sum())
                pos = kg["pos"][real].cpu().numpy()
                bad_pos += int((~true.holds(pos[:, 0], pos[:, 1], pos[:, 2])
                                | (pos[:, 0] < lo) | (pos[:, 0] >= hi)
                                | (pos[:, 2] < lo) | (pos[:, 2] >= hi))
                               .sum())
                if self.scheme != "per_slot":
                    bad_cand += draws.out_of_range(kg["ch"], lo, hi) + \
                        draws.out_of_range(kg["ct"], lo, hi)
                    continue
                cand, head, p = kg["cand"], kg["head"], kg["pos"]
                target = torch.where(head, p[:, 0:1], p[:, 2:3])
                if parts is None:
                    bad_cand += draws.out_of_range(cand, lo, hi)
                else:
                    bad_cand += draws.not_from_rows(
                        cand.reshape(-1), target.reshape(-1), parts, lo, hi)
                hs = torch.where(head, cand, p[:, 0:1]).cpu().numpy()
                ts = torch.where(head, p[:, 2:3], cand).cpu().numpy()
                rs = p[:, 1:2].expand_as(cand).cpu().numpy()
                keep = torch.as_tensor(~bloom.holds(hs, rs, ts),
                                       dtype=torch.float32, device=cand.device)
                keep_bad += int((keep != kg["keep"]).sum())
                kg["keep"] = keep
        out = {"bad_positives": bad_pos, "bad_candidates": bad_cand}
        if bloom is not None:
            out["keep_mismatches"] = keep_bad
        return out

    def _loss_fn(self):
        if self.scheme == "per_slot":
            return transe.per_slot_loss
        k = self.cfg.neg_triple_num
        return lambda read, kgs: transe.chunk_shared_loss(read, kgs, k)

    def reference(self, prec=transe.FLOAT64) -> dict:
        e0, r0 = data.relation_view_tables(self.seed, self.n_ent, self.n_rel,
                                           self.cfg.dim, self.device)
        return transe.follow({"rv_ent": e0, "rel": r0}, self.ref_steps,
                             self._loss_fn(), self.cfg.learning_rate, prec)

    def check(self) -> dict:
        """The numbers that decide ``correct``: the checked steps' inputs
        against what the sampling stage may draw, then the program's losses,
        first-gradient norms and change against the reference's."""
        self.ref_steps = self._reference_steps()
        numbers = self._draw_faults(self.ref_steps)
        self.ref = self.reference()
        numbers.update(self._gaps(self.program))
        return numbers

    def _gaps(self, got: dict) -> dict:
        ref = self.ref
        return {"loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
                "grad_gap": compare.leaf_gap(got["grad_norms"],
                                             ref["grad_norms"],
                                             ref["grad_norms"]),
                "delta_gap": compare.leaf_gap(got["delta_norms"],
                                              ref["delta_norms"],
                                              ref["grad_norms"])}

    def control(self) -> dict:
        """The control's numbers (after :meth:`check`): the reference in
        TF32, put in the program's place."""
        return self._gaps(self.reference(transe.TF32))
