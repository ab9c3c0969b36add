"""Rank processes of the port's mesh tests (tests/test_torch_mesh.py and
tests/test_torch_mesh_trainer.py); this file has no test functions.

A test starts N fresh interpreters of this file (:func:`start`), one per
rank, which import the port and never JAX. Each joins a gloo process group
on the CPU through a ``file://`` store under the test's ``tmp_path`` (so
parallel test workers never share a port), with a 60 s timeout, and runs
one task on inputs the test saved with ``torch.save``; rank 0 saves the
results. :func:`finish` waits for every rank with a timeout and fails on
any rank's failure.

    python tests/test_torch_mesh_ranks.py TASK IN.pt OUT.pt
"""
from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = ((0, 20), (20, 41))
# tables whose placement (table_spec) is held against the JAX package's
SPEC_TABLES = ("rv_ent", "av_ent", "ent", "rel", "attr", "conv_av",
               "nv_mapping")


# ---------------------------------------------------------------------------
# launching (test side)
# ---------------------------------------------------------------------------

def start(task: str, n: int, payload, folder):
    """Start ``n`` rank processes of ``task`` on ``payload``; ``folder``
    (a fresh directory) holds the inputs, the store and the results."""
    os.makedirs(folder, exist_ok=True)
    inp, out = os.path.join(folder, "in.pt"), os.path.join(folder, "out.pt")
    torch.save(payload, inp)
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(n),
               MESH_TEST_STORE="file://" + os.path.join(folder, "store"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # output to files, not pipes: a rank blocked on a full pipe would hang
    # the others in their next collective
    logs = [os.path.join(folder, f"rank{r}.log") for r in range(n)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), task, inp, out],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                stdout=f, stderr=subprocess.STDOUT))
    return procs, logs, out


def finish(handle, timeout: float = 240):
    """(rank 0's results, every rank's output); a rank that fails or hangs
    fails the test, and no rank outlives the call."""
    procs, logs, out = handle
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for path in logs:
        with open(path, errors="replace") as f:
            texts.append(f.read())
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return torch.load(out, weights_only=True), texts


# ---------------------------------------------------------------------------
# tasks (rank side)
# ---------------------------------------------------------------------------

def _mesh(dp, tp):
    from multike_tpu_torch.config import Config
    from multike_tpu_torch.parallel.context import MeshContext

    return MeshContext.from_config(Config(mesh_dp=dp, mesh_tp=tp), "cpu")


def _build(cfg, case, pctx):
    from multike_tpu_torch.train import streams

    kind = case["kind"]
    if kind == "rel_view":
        return streams.build_rel_view_epoch(
            cfg, case["n1"], case["n2"], RANGES,
            with_neighbors=case["nbr"], pctx=pctx)[0]
    if kind == "attr_view":
        return streams.build_attr_view_epoch(cfg, case["n1"], case["n2"],
                                             pctx)[0]
    return getattr(streams, f"build_{kind}_epoch")(cfg, case["n"], pctx)[0]


def step_case(cfg_kw, case, pctx):
    """One injected step of a stream from whole (padded) tables; returns
    the loss and the whole tables and accumulators after it."""
    from multike_tpu_torch.config import Config

    cfg = Config(row_sparse_updates=True, **cfg_kw, **case["cfg"])
    epoch = _build(cfg, case, pctx)
    params, acc = case["params"], case["acc"]
    if pctx is not None:
        params, acc = pctx.shard_params(params), pctx.shard_params(acc)
    lead = [] if case["consts"] is None else [case["consts"]]
    loss = epoch.step(params, acc, *lead, *case["batch"])
    if pctx is not None:
        params, acc = pctx.gather_tree(params), pctx.gather_tree(acc)
    return {"loss": float(loss), "params": params, "acc": acc}


def task_kernels(p):
    """At (2, 2): row_apply_sharded, tp_lookup, the ring over all 4 ranks,
    one step of each stream case, and spmd.dryrun."""
    import torch.distributed as dist

    from multike_tpu_torch.eval.ring import ring_rank_and_align
    from multike_tpu_torch.parallel import distributed
    from multike_tpu_torch.parallel.context import row_apply_sharded
    from multike_tpu_torch.parallel.spmd import dryrun
    from multike_tpu_torch.parallel.tp_lookup import make_tp_lookup, tp_lookup

    pctx = _mesh(2, 2)
    out = {}
    a = p["row_apply"]
    param = pctx.shard_params({"rv_ent": a["param"]})["rv_ent"]
    acc = pctx.shard_params({"rv_ent": a["acc"]})["rv_ent"]
    sl = pctx.dp_block(len(a["ids"]))
    row_apply_sharded(pctx, "rv_ent", param, acc, a["ids"][sl], a["g"][sl],
                      a["lr"])
    out["row_apply"] = [pctx.gather_table(param, "rv_ent"),
                        pctx.gather_table(acc, "rv_ent")]

    block, true_n = pctx.put_edge_partitioned(p["edges"].numpy())
    out["helpers"] = dict(
        specs={t: pctx.table_spec(t) for t in SPEC_TABLES},
        round_batch=[pctx.round_batch(n) for n in (1, 20, 21)],
        edge_block=block, edge_n=true_n,
        to_host=torch.as_tensor(pctx.to_host(param, "rv_ent")))

    t = p["tp_lookup"]
    shard = distributed.local_block(t["table"], pctx.tp, pctx.tp_index)
    out["tp_lookup"] = [tp_lookup(pctx.tp_group, shard, t["ids"]),
                        make_tp_lookup(pctx.tp_group, normalize=True)(
                            shard, t["ids"])]

    out["ring"] = [list(map(torch.as_tensor, ring_rank_and_align(
        dist.group.WORLD, c["e1"].numpy(), c["e2"].numpy(),
        csls_k=c["csls_k"], device="cpu"))) for c in p["ring"]]
    out["steps"] = {name: step_case(p["cfg"], case, pctx)
                    for name, case in p["steps"].items()}
    out["dryrun"] = dryrun(2, 2, device="cpu")
    return out


def trainer_run(folder: str, cfg_kw, dp: int = 1, tp: int = 1):
    """A fresh trainer on ``folder`` (its literal cache already written):
    valid nv and rv and test rv, then one epoch of every stream in the ITC
    driver's order; returns the MRRs, the losses and the entity tables."""
    from multike_tpu_torch.align.predicates import PredicateAlignModel
    from multike_tpu_torch.config import Config
    from multike_tpu_torch.data.dataset import DataModel
    from multike_tpu_torch.eval import views as vw
    from multike_tpu_torch.train.trainer import MultiKETrainer

    cfg = Config(training_data=folder, word2vec_path=folder +
                 "mini_word2vec.vec", retrain_literal_embeds=False,
                 mesh_dp=dp, mesh_tp=tp, **cfg_kw)
    data = DataModel(cfg, device="cpu")
    tr = MultiKETrainer(cfg, data, PredicateAlignModel(data.kgs, cfg),
                        verbose=False, device="cpu")
    evals = {"valid_nv": vw.valid(tr, "nv"), "valid_rv": vw.valid(tr, "rv"),
             "test_rv": vw.test(tr, "rv")}
    kgs, pam = tr.kgs, tr.predicate_align_model
    ents = kgs.kg1.entities_list + kgs.kg2.entities_list
    losses = {
        "rel_view": tr.train_relation_view_1epo(1),
        "ckge_rel": tr.train_cross_kg_entity_inference_relation_view_1epo(
            1, kgs.kg1.sup_relation_triples_list
            + kgs.kg2.sup_relation_triples_list),
        "ckgp_rel": tr.train_cross_kg_relation_inference_1epo(
            1, pam.sup_relation_alignment_triples1
            + pam.sup_relation_alignment_triples2),
        "attr_view": tr.train_attribute_view_1epo(1),
        "ckge_attr": tr.train_cross_kg_entity_inference_attribute_view_1epo(
            1, kgs.kg1.sup_attribute_triples_list
            + kgs.kg2.sup_attribute_triples_list),
        "ckga_attr": tr.train_cross_kg_attribute_inference_1epo(
            1, pam.sup_attribute_alignment_triples1
            + pam.sup_attribute_alignment_triples2),
        "common_space": tr.train_common_space_learning_1epo(1, ents),
        "space_mapping": tr.train_shared_space_mapping_1epo(1, ents)}
    tr.generate_neighbors()
    losses["rel_view_truncated"] = tr.train_relation_view_1epo(2)
    tables = {t: tr._table(t) for t in ("rv_ent", "av_ent", "ent")}
    return {"evals": evals, "losses": losses, "tables": tables}


def task_trainer(p):
    return trainer_run(p["folder"], p["cfg"], *p["mesh"])


def task_cli(p):
    """The CLI twice on the same arguments: a run that checkpoints, then a
    run that resumes from its last checkpoint (reading the literal cache
    the first wrote). Returns both results and the second run's log."""
    from multike_tpu_torch import cli

    first = cli.main(p["argv"])
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        second = cli.main(p["argv"] + ["--set",
                                       "retrain_literal_embeds=false"])
    return {"first": first, "second": second, "log": log.getvalue()}


def task_trainer_cli(p):
    """:func:`task_trainer`, then :func:`task_cli`, in one process group."""
    return {"trainer": task_trainer(p["trainer"]), "cli": task_cli(p["cli"])}


TASKS = {"kernels": task_kernels, "trainer": task_trainer, "cli": task_cli,
         "trainer_cli": task_trainer_cli}


def main():
    import torch.distributed as dist

    from multike_tpu_torch.parallel import distributed

    task, inp, out = sys.argv[1:4]
    torch.set_num_threads(1)
    distributed.init_distributed(backend="gloo", device="cpu",
                                 init_method=os.environ["MESH_TEST_STORE"],
                                 timeout_s=60)
    result = TASKS[task](torch.load(inp, weights_only=True))
    if distributed.rank() == 0:
        torch.save(result, out)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
