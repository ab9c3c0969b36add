"""Traffic kind ``itc``: whole driver epochs of the port's ITC trainer
(``MultiKE_ITC.train_streams_1epo``, the call its ``_run`` makes each
epoch), back to back, on a KG pair made from the seed.

The mix gives the pair (``lib/itc_data.py``: ``entities_per_kg``,
``triples``, ``relations``, ``attributes``, ``attribute_triples``,
``links``, ``shared_names``), the driver epoch the window stands at
(``epoch``), the entities a KG whose refreshed neighbour rows are checked
(``neighbor_sample``) and ``config``, the Config keys the mix sets.

Set-up builds the program's own ``KGs`` from the seeded triples and links,
its ``PredicateAlignModel`` from the seeded predicate names (written for it
to read into a temporary folder), and ``MultiKE_ITC`` on a data object
whose name and literal vectors are seeded unit rows; every table the
streams train is then set from the seed. It runs one neighbour refresh and
one predicate refresh, as the published schedule does at epoch 20, and one
warm-up driver epoch, whose every step is recorded: its inputs, its loss,
each stream's first gradient (from its accumulators) and each table's
change at the end of each stream. The window runs whole driver epochs; no
evaluation and no refresh falls in it.

``correct`` is decided after the window: the recorded inputs against what
each stream may draw, the refreshed neighbour rows of a sample of entities
against a float64 top-k of the seeded table, and the program's losses,
first gradients and changes, stream by stream, against
``reference/multike.py`` following the whole warm-up epoch in float64 from
the seeded tables, carrying its state from stream to stream.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
import types

import numpy as np
import torch

from gpubench.lib import bounds, bounds_itc, compare, itc_data
from gpubench.reference import draws, multike, transe

NEAR_TIE = 1e-5
"""How far under the k-th largest float64 similarity a refreshed neighbour
may lie. The program ranks in float32: each similarity is a sum of 75
products of l2-normalized rows, whose rounding error is at most
75 * 2**-24 = 4.5e-6 of the sum of the products' magnitudes (at most 1),
with a few units of 2**-24 more from the normalization; 1e-5 is above that
bound, and lets two entities whose similarities lie that close swap places
at the k-th."""

SAMPLED = ("ckge_rel", "ckgp_rel", "ckge_attr", "ckga_attr", "common_space")
KEYS = {"ckge_rel": ("pos",), "ckgp_rel": ("pos", "w"),
        "attr_view": ("pos", "w", "mask"), "ckge_attr": ("pos",),
        "ckga_attr": ("pos", "w"), "common_space": ("ents",)}
CONV_STREAMS = ("attr_view", "ckge_attr", "ckga_attr")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _proportional(n1: int, n2: int, batch: int):
    bs1 = int(n1 / (n1 + n2) * batch)
    return bs1, batch - bs1


def _chunks(bs: int, chunk: int):
    nc = max(1, -(-bs // max(1, chunk)))
    return nc, -(-bs // nc)


class _Rows:
    """Membership of int64 rows of three columns in a set of such rows,
    with a fourth column (a weight) looked up for each."""

    def __init__(self, rows: np.ndarray, weights: np.ndarray = None):
        rows = np.asarray(rows, np.int64).reshape(-1, 3)
        self.base = (int(rows[:, 1].max()) + 1, int(rows[:, 2].max()) + 1)
        order = np.argsort(self._key(rows), kind="stable")
        self.keys = self._key(rows)[order]
        self.weights = None if weights is None else \
            np.asarray(weights, np.float32)[order]

    def _key(self, rows):
        return (rows[:, 0] * self.base[0] + rows[:, 1]) * self.base[1] \
            + rows[:, 2]

    def find(self, rows: np.ndarray):
        """(found, weight): each row is in the set, and its weight."""
        rows = np.asarray(rows, np.int64).reshape(-1, 3)
        inside = (rows[:, 1] < self.base[0]) & (rows[:, 2] < self.base[1]) \
            & (rows >= 0).all(1)
        k = self._key(np.where(inside[:, None], rows, 0))
        i = np.clip(np.searchsorted(self.keys, k), 0, len(self.keys) - 1)
        found = inside & (self.keys[i] == k)
        return found, (None if self.weights is None else self.weights[i])


def _swapped(triples: np.ndarray, train: np.ndarray, entities: int,
             kg: int, cols=(0, 2)) -> np.ndarray:
    """The swapped supervision triples of KG ``kg``'s ``triples``: each
    triple whose entity in column ``cols`` (heads and tails of relation
    triples, heads of attribute triples) is linked by a training link, with
    that entity replaced by its counterpart, one column at a time."""
    partner = np.full(entities, -1, np.int64)
    partner[train[:, kg]] = train[:, 1 - kg]
    out = []
    for col in cols:
        hit = partner[triples[:, col]] >= 0
        new = triples[hit].copy()
        new[:, col] = partner[new[:, col]]
        out.append(new)
    return np.unique(np.concatenate(out), axis=0)


class _Launches(torch.autograd.Function):
    """Runs ``fn(*args)`` as one PyTorch operation. K1 launches its
    kernels through ctypes, outside PyTorch's operations, and the profiler
    links a kernel to the operation it was launched in: K1's kernels would
    carry no link, and ``lib/trace.py`` could place them in no range. Inside
    this operation they are linked to it, and so fall in the ranges around
    it. The result is ``fn``'s, kept in ``out``."""

    @staticmethod
    def forward(ctx, anchor, fn, args, kwargs, out):
        out.append(fn(*args, **kwargs))
        return anchor.new_empty(0)


def _linked(fn):
    def call(*args, **kwargs):
        out = []
        _Launches.apply(args[0], fn, args, kwargs, out)
        return out[0]
    return call


def _table_rows(seq) -> np.ndarray:
    return np.asarray(seq, np.float64).reshape(-1, 4)


class Cell:
    def __init__(self, cfg, mix: dict, seed: int, device, rec):
        from multike_tpu_torch.train.itc import MultiKE_ITC

        if not hasattr(MultiKE_ITC, "train_streams_1epo"):
            raise RuntimeError(
                "the program's MultiKE_ITC has no train_streams_1epo: this "
                "cell runs the driver's epochs through it")
        self.cfg, self.mix, self.seed, self.device, self.rec = (
            cfg, mix, seed, device, rec)
        self.n = n = mix["entities_per_kg"]
        self.n_ent = 2 * n
        self.ranges = ((0, n), (n, 2 * n))
        self.pair = itc_data.pair(seed, mix)
        self.n_rel = sum(mix["relations"])
        self.n_attr = sum(mix["attributes"])
        self.model = self._build(MultiKE_ITC)
        self.initial = itc_data.tables(seed, self.n_ent, self.n_rel,
                                       self.n_attr, cfg.dim, device)
        for name, table in self.initial.items():
            for dst, src in zip(multike.flat({name: self.model.params[name]})
                                .values(),
                                multike.flat({name: table}).values()):
                dst.copy_(src)
        # epoch 20 of the published schedule: both refreshes
        self.model.generate_neighbors()
        pam = self.model.predicate_align_model
        pam.update_predicate_alignment(self.model.current_embeds("rel"))
        pam.update_predicate_alignment(self.model.current_embeds("attr"),
                                       predicate_type="attribute")
        self.rel_inference = (pam.sup_relation_alignment_triples1
                              + pam.sup_relation_alignment_triples2)
        self.attr_inference = (pam.sup_attribute_alignment_triples1
                               + pam.sup_attribute_alignment_triples2)
        self.epoch_i = mix["epoch"]
        self._warm_up()
        self.epoch_flops = self._epoch_flops()

    # ------------------------------------------------------------------
    def _build(self, cls):
        """The program's KGs, predicate model and trainer on the seeded
        pair; checks that its ids are the pair's."""
        from multike_tpu_torch.align.predicates import PredicateAlignModel
        from multike_tpu_torch.data.kg import KG, KGs

        p = self.pair
        kgs = []
        for k in range(2):
            rn = [itc_data.relation_name(k + 1, i)
                  for i in range(self.mix["relations"][k])]
            an = [itc_data.attribute_name(k + 1, i)
                  for i in range(self.mix["attributes"][k])]
            r, a = p["rel"][k], p["attr"][k]
            rl, al = p["rel_lo"][k], p["attr_lo"][k]
            kgs.append(KG(
                zip(r[:, 0].tolist(), [rn[x - rl] for x in r[:, 1].tolist()],
                    r[:, 2].tolist()),
                zip(a[:, 0].tolist(), [an[x - al] for x in a[:, 1].tolist()],
                    a[:, 2].tolist())))
        links = {k: [tuple(x) for x in v.tolist()]
                 for k, v in p["links"].items()}
        kgs = KGs(kgs[0], kgs[1], links["train"], links["valid"],
                  links["test"], mode=self.cfg.alignment_module,
                  ordered=False)
        self._check_ids(kgs)
        names, literals = itc_data.vectors(self.seed, self.n_ent,
                                           p["values"], self.cfg.dim)
        data = types.SimpleNamespace(kgs=kgs, local_name_vectors=names,
                                     value_vectors=literals)
        with tempfile.TemporaryDirectory() as folder:
            for k in range(2):
                path = os.path.join(folder, f"predicate_local_name_{k + 1}")
                with open(path, "w", encoding="utf-8") as f:
                    for i, name in enumerate(p["rel_names"][k]):
                        f.write(f"{itc_data.relation_name(k + 1, i)}\t"
                                f"{name}\n")
                    for i, name in enumerate(p["attr_names"][k]):
                        f.write(f"{itc_data.attribute_name(k + 1, i)}\t"
                                f"{name}\n")
            cfg = self.cfg.replace(training_data=folder + os.sep)
            pam = PredicateAlignModel(kgs, cfg)
        return cls(self.cfg, data, pam, verbose=False, device=self.device)

    def _check_ids(self, kgs):
        p, n = self.pair, self.n
        bad = kgs.entity_id_ranges() != ((0, n), (n, 2 * n)) or \
            kgs.entities_num != 2 * n
        for k, kg in enumerate((kgs.kg1, kgs.kg2)):
            bad |= any(kg.relations_id_dict[itc_data.relation_name(k + 1, i)]
                       != p["rel_lo"][k] + i
                       for i in range(self.mix["relations"][k]))
            bad |= any(kg.attributes_id_dict[
                itc_data.attribute_name(k + 1, i)] != p["attr_lo"][k] + i
                for i in range(self.mix["attributes"][k]))
        if bad:
            raise RuntimeError("the program's ids are not the seeded pair's")

    # ------------------------------------------------------------------
    def _run_epoch(self, i: int) -> dict:
        return self.model.train_streams_1epo(i, self.rel_inference,
                                             self.attr_inference)

    def _warm_up(self):
        """One driver epoch through the program's own call, every step
        recorded (see the module's docstring)."""
        model = self.model
        steps, first, deltas = [], {}, {}
        initial = multike.flat(self.initial)
        wrapped = {}
        get = model._get_epoch_fn

        def close(stream):
            mine = multike.flat({t: model.params[t]
                                 for t in multike.STREAMS[stream]})
            deltas[stream] = {k: (v.double() - initial[k].double()).norm()
                              for k, v in mine.items()}

        def recorded(stream, step):
            def run(params, opt_state, *batch):
                if not steps or steps[-1][0] != stream:
                    if steps:
                        close(steps[-1][0])
                    acc0 = {k: v.clone() for k, v in
                            multike.flat(opt_state).items()}
                loss = step(params, opt_state, *batch)
                if stream not in first:
                    first[stream] = {
                        k: (v.double() - acc0[k].double()).sum().sqrt()
                        for k, v in multike.flat(opt_state).items()}
                steps.append((stream, tuple(x.detach().clone()
                                            for x in batch
                                            if torch.is_tensor(x)), loss))
                return loss
            return run

        def get_recorded(kind, *key):
            out = get(kind, *key)
            epoch = out[0]
            if id(epoch) not in wrapped:
                wrapped[id(epoch)] = (epoch, epoch.__dict__.get("step"))
                epoch.step = recorded(kind, epoch.step)
            return out

        model._get_epoch_fn = get_recorded
        try:
            losses = self._run_epoch(self.epoch_i)
        finally:
            del model._get_epoch_fn
            for epoch, step in wrapped.values():
                if step is None:
                    del epoch.step
                else:
                    epoch.step = step
        if not all(math.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"the warm-up epoch's losses are {losses}")
        close(steps[-1][0])
        self.streams = list(dict.fromkeys(s for s, _, _ in steps))
        if len(self.streams) != len(multike.STREAMS):
            raise RuntimeError(f"the warm-up epoch ran {self.streams}")
        self.epochs = {kind: fn[0] for (kind, *_), fn in
                       model._epoch_fns.items()}
        self.steps = [(s, b) for s, b, _ in steps]
        self.steps_of = {s: sum(1 for x, _ in self.steps if x == s)
                         for s in self.streams}
        loss = torch.stack([x.float() for _, _, x in steps]).tolist()
        self.program = {s: {"losses": [], "grad_norms": {
            k: float(v) for k, v in first[s].items()},
            "delta_norms": {k: float(v) for k, v in deltas[s].items()}}
            for s in self.streams}
        for (s, _), x in zip(self.steps, loss):
            self.program[s]["losses"].append(x)
        self.nbr = model.neighbors
        self.trained = self.epochs["rel_view"].trained_per_epoch
        _sync(self.device)

    def _epoch_flops(self) -> float:
        """The model FLOPs of one driver epoch (lib/bounds.py,
        lib/bounds_itc.py), from the warm-up epoch's steps."""
        d = self.cfg.dim
        rv = self.epochs["rel_view"]
        total = 0
        for stream, batch in self.steps:
            if stream == "rel_view":
                kgs = self._rel_batch(batch)
                ents = torch.cat([torch.cat([kg["pos"][kg["mask"] > 0][:, 0],
                                             kg["pos"][kg["mask"] > 0][:, 2],
                                             kg["ch"].reshape(-1),
                                             kg["ct"].reshape(-1)])
                                  for kg in kgs])
                rels = torch.cat([kg["pos"][kg["mask"] > 0][:, 1]
                                  for kg in kgs])
                real = sum(int((kg["mask"] > 0).sum()) for kg in kgs)
                chunks = sum(kg["ch"].shape[0] for kg in kgs)
                total += bounds.chunk_step_flops(
                    d, real, chunks, rv.pool,
                    _distinct(ents) + _distinct(rels))
                continue
            b = dict(zip(KEYS[stream], batch))
            if stream == "common_space":
                total += bounds_itc.common_space_step_flops(
                    d, b["ents"].shape[0], 3 * _distinct(b["ents"]))
                continue
            pos = b["pos"]
            if "mask" in b:
                pos = pos[b["mask"] > 0]
            rows = pos.shape[0]
            if stream in CONV_STREAMS:
                total += bounds_itc.conv_step_flops(
                    d, rows, _distinct(pos[:, 0]) + _distinct(pos[:, 1]))
            else:
                total += bounds_itc.transe_pos_step_flops(
                    d, rows, _distinct(torch.cat([pos[:, 0], pos[:, 2]]))
                    + _distinct(pos[:, 1]))
        return float(total)

    # ------------------------------------------------------------------
    def trace_hooks(self):
        """Ranges around every stream's step, the optimizer's applies, K1
        (the row-sparse apply, run as one PyTorch operation: ``_Launches``)
        and the CNN scorer, for a traced window."""
        from multike_tpu_torch.train import sparse_adagrad, streams

        rec = self.rec
        saved = [(e, e.__dict__.get("step")) for e in self.epochs.values()]
        for epoch in self.epochs.values():
            epoch.step = rec.wrap(epoch.step, "step")
        applies = (sparse_adagrad.dense_apply, sparse_adagrad.row_apply,
                   streams.conv_score)
        sparse_adagrad.dense_apply = rec.wrap(applies[0], "apply")
        sparse_adagrad.row_apply = rec.wrap(
            rec.wrap(_linked(applies[1]), "k1"), "apply")
        streams.conv_score = rec.wrap(applies[2], "conv")

        def undo():
            for epoch, step in saved:
                if step is None:
                    del epoch.step
                else:
                    epoch.step = step
            (sparse_adagrad.dense_apply, sparse_adagrad.row_apply,
             streams.conv_score) = applies
        return ("step", "apply", "k1", "conv"), undo

    def window(self, seconds: float) -> dict:
        epochs = failed = 0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            losses = self._run_epoch(self.epoch_i + 1 + epochs)
            epochs += 1
            failed += not all(math.isfinite(v) for v in losses.values())
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.rec.count("epochs", epochs)
        self.rec.count("steps", epochs * len(self.steps))
        self.rec.count("conv_steps", epochs * sum(
            self.steps_of[s] for s in CONV_STREAMS))
        self.rec.count("triples", epochs * self.trained)
        self.rec.count("model_flops", epochs * self.epoch_flops)
        self.rec.count("dim", self.cfg.dim)       # K1's row width
        return dict(window_s=elapsed, attempted=epochs, failed=failed,
                    metrics={})

    def free(self):
        """Drops the program's state, before the reference runs; keeps the
        recorded steps, the refreshed neighbour table and the predicate
        model's lists."""
        pam = self.model.predicate_align_model
        self.pam_lists = {
            "attr_view": (_table_rows(pam.attribute_triples_w_weights1),
                          _table_rows(pam.attribute_triples_w_weights2)),
            "ckgp_rel": _table_rows(self.rel_inference),
            "ckga_attr": _table_rows(self.attr_inference)}
        for name in ("model", "epochs", "rel_inference", "attr_inference"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def _rel_batch(self, batch):
        keys = ("pos", "mask", "ch", "ct")
        return [dict(zip(keys, batch[:4])), dict(zip(keys, batch[4:]))]

    def _expected_mask(self, stream, i):
        """The mask the epoch's i-th step should carry: real slots j < bs
        of each KG at global position i * bs + j < n (chunk padding and
        the epoch's tail masked)."""
        cfg, dev = self.cfg, self.device
        if stream == "rel_view":
            n = [len(t) for t in self.pair["rel"]]
            bss = _proportional(*n, cfg.batch_size)
            chunk = cfg.truncated_chunk_size
            out = []
            for bs, m in zip(bss, n):
                nc, s = _chunks(bs, chunk)
                j = torch.arange(nc * s, device=dev)
                out.append(((j < bs) & (i * bs + j < m)).float())
            return out
        n = [len(t) for t in self.pam_lists["attr_view"]]
        bss = _proportional(*n, cfg.attribute_batch_size)
        return torch.cat([((i * bs + torch.arange(bs, device=dev)) < m)
                          .float() for bs, m in zip(bss, n)])

    def _reference_steps(self):
        """The recorded steps as the reference takes them, with the masks
        they should carry; also the count of masks that differ."""
        out, counts, bad = [], {}, 0
        for stream, batch in self.steps:
            i = counts[stream] = counts.get(stream, -1) + 1
            if stream == "rel_view":
                kgs = self._rel_batch(batch)
                for kg, mask in zip(kgs, self._expected_mask(stream, i)):
                    bad += int((kg["mask"] != mask).sum())
                    kg["mask"] = mask
                out.append((stream, kgs))
                continue
            b = dict(zip(KEYS[stream], batch))
            if stream == "attr_view":
                mask = self._expected_mask(stream, i)
                bad += int((b["mask"] != mask).sum())
                b["mask"] = mask
            out.append((stream, b))
        return out, bad

    def _draw_faults(self, steps) -> dict:
        p = self.pair
        true_rel = _Rows(np.concatenate(p["rel"]))
        true_attr = _Rows(np.concatenate(p["attr"]))
        train = p["links"]["train"]
        lists = {
            "ckge_rel": _Rows(np.concatenate([
                _swapped(p["rel"][k], train, self.n_ent, k)
                for k in range(2)])),
            "ckge_attr": _Rows(np.concatenate([
                _swapped(p["attr"][k], train, self.n_ent, k, cols=(0,))
                for k in range(2)])),
            "ckgp_rel": _Rows(self.pam_lists["ckgp_rel"][:, :3],
                              self.pam_lists["ckgp_rel"][:, 3]),
            "ckga_attr": _Rows(self.pam_lists["ckga_attr"][:, :3],
                               self.pam_lists["ckga_attr"][:, 3])}
        weighted = np.concatenate(self.pam_lists["attr_view"])
        lists["attr_view"] = _Rows(weighted[:, :3], weighted[:, 3])
        bad = dict(bad_positives=0, bad_candidates=0, bad_weights=0,
                   repeated_rows=0)
        for stream, b in steps:
            if stream == "rel_view":
                for kg, (lo, hi) in zip(b, self.ranges):
                    real = kg["mask"] > 0
                    pos = kg["pos"][real].cpu().numpy()
                    bad["bad_positives"] += int(
                        (~true_rel.find(pos)[0] | (pos[:, 0] < lo)
                         | (pos[:, 0] >= hi) | (pos[:, 2] < lo)
                         | (pos[:, 2] >= hi)).sum())
                    nc = kg["ch"].shape[0]
                    for col, pool in ((0, kg["ch"]), (2, kg["ct"])):
                        bad["bad_candidates"] += multike.pools_not_from_rows(
                            pool, kg["pos"][:, col].reshape(nc, -1),
                            real.reshape(nc, -1), self.nbr.nbr,
                            self.nbr.cnt, lo, hi)
                continue
            if stream == "common_space":
                ents = b["ents"]
                bad["bad_positives"] += draws.out_of_range(ents, 0,
                                                           self.n_ent)
                bad["repeated_rows"] += ents.numel() - _distinct(ents)
                continue
            pos = b["pos"]
            if "mask" in b:
                pos = pos[b["mask"] > 0]
            rows = pos.cpu().numpy()
            found, w = lists[stream].find(rows)
            if stream == "attr_view":
                found &= true_attr.find(rows)[0]
            bad["bad_positives"] += int((~found).sum())
            if w is not None:
                got = b["w"] if "mask" not in b else b["w"][b["mask"] > 0]
                bad["bad_weights"] += int(
                    (found & (got.cpu().numpy() != w)).sum())
            if stream in SAMPLED:
                bad["repeated_rows"] += rows.shape[0] - _distinct(pos)
        return bad

    def _neighbor_mismatches(self) -> int:
        """Refreshed neighbour rows of ``neighbor_sample`` entities a KG,
        against the float64 top-k of the seeded relation-view table among
        the KG's entities (all are linked, so all have rows): an id counts
        where it is repeated, outside the KG or under the k-th largest
        similarity by more than ``NEAR_TIE``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        rv = transe.normalize(self.initial["rv_ent"].double())
        bad = 0
        for lo, hi in self.ranges:
            size = min(self.mix["neighbor_sample"], hi - lo)
            sample = lo + torch.randperm(hi - lo, generator=gen,
                                         device=self.device)[:size]
            k = self.nbr.cnt[sample]
            if bool((k != k[0]).any()) or int(k[0]) == 0:
                return size * (hi - lo)
            k = int(k[0])
            got = self.nbr.nbr[sample, :k].long()
            sims = rv[sample] @ rv[lo:hi].T
            kth = torch.topk(sims, k, dim=1).values[:, -1:]
            inside = (got >= lo) & (got < hi)
            at = torch.gather(sims, 1, torch.where(inside, got - lo, 0))
            bad += int((~inside | (at < kth - NEAR_TIE)).sum())
            ordered = got.sort(dim=1).values
            bad += int((ordered[:, 1:] == ordered[:, :-1]).sum())
        return bad

    def reference(self, prec=transe.FLOAT64) -> dict:
        cfg = self.cfg
        names, literals = itc_data.vectors(self.seed, self.n_ent,
                                           self.pair["values"], cfg.dim)
        consts = {"name_embeds": torch.as_tensor(names, device=self.device),
                  "literal_embeds": torch.as_tensor(literals,
                                                    device=self.device)}
        rates = {s: cfg.learning_rate for s in multike.STREAMS}
        rates["common_space"] = cfg.ITC_learning_rate
        return multike.follow(self.initial, consts, self.ref_steps, rates,
                              cfg.neg_triple_num, cfg.cv_weight,
                              cfg.cv_name_weight, prec)

    def check(self) -> dict:
        """The numbers that decide ``correct``: the recorded steps' inputs
        against what each stream may draw, the refreshed neighbour rows,
        then each stream's losses, first-gradient norms and changes against
        the reference's."""
        self.ref_steps, bad_masks = self._reference_steps()
        numbers = self._draw_faults(self.ref_steps)
        numbers["bad_positives"] += bad_masks
        numbers["neighbor_mismatches"] = self._neighbor_mismatches()
        self.ref = self.reference()
        numbers.update(self._gaps(self.program))
        return numbers

    def _gaps(self, got: dict) -> dict:
        out = {}
        for s in self.streams:
            ref, mine = self.ref[s], got[s]
            out[f"loss_gap.{s}"] = compare.loss_gap(mine["losses"],
                                                    ref["losses"])
            out[f"grad_gap.{s}"] = compare.leaf_gap(
                mine["grad_norms"], ref["grad_norms"], ref["grad_norms"])
            out[f"delta_gap.{s}"] = compare.leaf_gap(
                mine["delta_norms"], ref["delta_norms"], ref["grad_norms"])
        return out

    def control(self) -> dict:
        """The control's numbers (after :meth:`check`): the reference in
        TF32, put in the program's place."""
        return self._gaps(self.reference(transe.TF32))


def _distinct(x: torch.Tensor) -> int:
    """Distinct rows of ``x`` (ids, or rows of ids)."""
    if x.dim() == 1:
        return int(torch.unique(x).numel())
    return int(torch.unique(x, dim=0).shape[0])
