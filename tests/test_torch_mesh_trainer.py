"""The port's trainer and CLI on a mesh against one rank, on the CPU (the
contracts of tests/test_mesh_trainer.py and tests/test_multiprocess.py).

Rank processes (tests/test_torch_mesh_ranks.py: gloo, a file store, the
port alone) run at once: ``MultiKETrainer`` at dp=2 x tp=2 (4 ranks) and
at dp=2 (2 ranks), then on those 2 ranks the ITC CLI twice, the second run
resuming from the first's epoch-10 checkpoint; beside them one process runs
the same CLI on one rank. Meanwhile this process runs the one-rank trainer.
A trainer runs valid nv, valid rv and test rv on its fresh tables (equal to
one rank's, rtol 1e-6), then one epoch of every stream and a truncated
rel_view epoch after a neighbour refresh (losses rtol 2e-3, entity tables
rtol 5e-4 / atol 5e-6). The mesh CLI's test MRRs lie within 0.02 of the
one-rank CLI's, and the resumed run restores epoch 10 exactly (the same
MRRs again).
"""
import json
import os
import shutil

import numpy as np
import pytest

import test_torch_mesh_ranks as ranks
from multike_tpu_torch.config import Config
from multike_tpu_torch.data import synthetic
from multike_tpu_torch.data.dataset import DataModel

TRAINER_CFG = dict(dim=16, batch_size=200, entity_batch_size=120,
                   encoder_epoch=2, neg_triple_num=4, learning_rate=0.05)
# tests/mp_driver_workload.py's compressed ITC driver: all streams, the
# truncated phase after refreshes at 3, 6 and 9, soft alignment from 2,
# evaluations at 4 and 8, checkpoints at 5 and 10
CLI_CFG = dict(dim=16, batch_size=100, entity_batch_size=64,
               attribute_batch_size=100, encoder_epoch=1, neg_triple_num=2,
               max_epoch=10, start_valid=4, eval_freq=4, truncated_freq=3,
               start_predicate_soft_alignment=2, checkpoint_freq=5,
               is_save=False, seed=11, row_sparse_updates="on")


def _cli_argv(tmp, name, mesh_dp):
    """CLI arguments on a copy of the driver dataset of its own."""
    folder = os.path.join(tmp, name, "ds") + "/"
    shutil.copytree(os.path.join(tmp, "cli_ds"), folder)
    args = os.path.join(tmp, name, "args.json")
    with open(args, "w") as f:
        json.dump(dict(CLI_CFG, word2vec_path=folder + "mini_word2vec.vec"),
                  f)
    return ["-m", "ITC", "-d", folder, "--args", args, "--device", "cpu",
            "--set", f"mesh_dp={mesh_dp}", "--set",
            "checkpoint_dir=" + os.path.join(tmp, name, "ckpt")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_trainer"))
    folder = synthetic.generate(os.path.join(tmp, "ds") + "/", seed=5)
    # the literal cache every trainer reads
    DataModel(Config(training_data=folder, word2vec_path=folder +
                     "mini_word2vec.vec", **TRAINER_CFG), device="cpu")
    synthetic.generate(os.path.join(tmp, "cli_ds") + "/", seed=21,
                       n_entities=120)
    trainer = dict(folder=folder, cfg=TRAINER_CFG)
    handles = {
        "tp": ranks.start("trainer", 4, dict(trainer, mesh=(2, 2)),
                          os.path.join(tmp, "tp")),
        "dp": ranks.start("trainer_cli", 2, dict(
            trainer=dict(trainer, mesh=(2, 1)),
            cli=dict(argv=_cli_argv(tmp, "cli_mesh", 2))),
            os.path.join(tmp, "dp")),
        "cli_one": ranks.start("cli", 1, dict(
            argv=_cli_argv(tmp, "cli_one", 1)), os.path.join(tmp, "one")),
    }
    one = ranks.trainer_run(folder, TRAINER_CFG)
    done = {k: ranks.finish(h, timeout=300)[0] for k, h in handles.items()}
    return one, done


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_mesh_trainer_equals_one_rank(runs, mesh):
    """dp=2 and dp=2 x tp=2 epochs give one rank's per-stream losses and
    tables: the same draws, only the float reduction order differs."""
    one, done = runs
    got = done[mesh]["trainer"] if mesh == "dp" else done[mesh]
    assert set(got["losses"]) == set(one["losses"]) and len(one["losses"]) == 9
    for k, v in one["losses"].items():
        assert np.isfinite(v) and np.isclose(got["losses"][k], v,
                                             rtol=2e-3), (k, got, one)
    for t, want in one["tables"].items():
        np.testing.assert_allclose(got["tables"][t].numpy(), want.numpy(),
                                   rtol=5e-4, atol=5e-6, err_msg=t)


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_mesh_eval_equals_one_rank(runs, mesh):
    """Evaluation on a mesh goes through the ring (K2 on each block) and
    returns one rank's MRRs."""
    one, done = runs
    got = done[mesh]["trainer"] if mesh == "dp" else done[mesh]
    for k, v in one["evals"].items():
        assert np.isclose(got["evals"][k], v, rtol=1e-6), (k, got, one)


def test_cli_two_ranks_with_resume(runs):
    """The ITC CLI at 2 ranks: test MRRs within 0.02 of one rank's; its
    second run resumes from the epoch-10 checkpoint and returns the first
    run's MRRs exactly."""
    _, done = runs
    mesh, one = done["dp"]["cli"], done["cli_one"]
    assert set(mesh["first"]) == {"nv", "rv", "av", "final"}
    for view, mrr in one["first"].items():
        assert abs(mesh["first"][view] - mrr) < 0.02, (view, mesh, one)
    assert "at epoch 10" in mesh["log"] and "resumed from" in mesh["log"]
    assert mesh["second"] == mesh["first"]
    assert one["second"] == one["first"]
