"""Saved embeddings and checkpoints (counterpart of
multike_tpu/persistence.py).

``save_embeddings`` writes the reference's artifact set: six ``.npy``
embedding dumps and six id-dict TSVs in ``<output>/<ClassName>/<dataset>/
<timestamp>/``.

Checkpoints are one ``.npz`` in the JAX package's key layout: every table
under ``params:<path>`` and every Adagrad accumulator under
``opt:<stream>/<table>``, a path being the ``['key']`` parts joined by
``/``, as ``jax.tree_util.tree_flatten_with_path`` names them. The slots of
Adam and Adadelta states take the places optax's chain states flatten to
(``opt:<stream>/[0]/.count``, ``opt:<stream>/[0]/.mu/['rv_ent']``,
``opt:<stream>/[1]/.e_g/...``; ``train/optimizers.OPTAX_SLOT_PATHS``); SGD
has none. So a checkpoint the JAX package wrote loads here, and the
reverse. The JAX package's PRNG key does not carry over: the port stores
``[seed, epoch]`` in its place and, on resume, reseeds its
``torch.Generator`` from the config's seed and the epoch
(:func:`resume_seed`).

``load_embeddings``, ``pair2file``, ``line2file``, ``radio_2file`` and
``save_results`` keep the reference's small file helpers.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from multike_tpu_torch.train.optimizers import OPTAX_SLOT_PATHS


def load_embeddings(file_name: str):
    """The array saved in ``file_name``, or None when there is no file."""
    if os.path.exists(file_name):
        return np.load(file_name)
    return None


def pair2file(file: str, pairs) -> None:
    if pairs is None:
        return
    with open(file, "w", encoding="utf8") as f:
        for i, j in pairs:
            f.write(f"{i}\t{j}\n")


def line2file(file: str, lines) -> None:
    if lines is None:
        return
    with open(file, "w", encoding="utf8") as f:
        for line in lines:
            f.write(line + "\n")


def radio_2file(radio, folder: str) -> str:
    """The split-ratio subfolder of ``folder`` ('.' -> '_'), created."""
    path = folder + str(radio).replace(".", "_")
    os.makedirs(path, exist_ok=True)
    return path + "/"


def save_results(folder: str, rest_12) -> None:
    os.makedirs(folder, exist_ok=True)
    pair2file(os.path.join(folder, "alignment_results_12"), rest_12)
    print("Results saved!")


def dict2file(file: str, dic) -> None:
    if dic is None:
        return
    with open(file, "w", encoding="utf8") as f:
        for i, j in dic.items():
            f.write(f"{i}\t{j}\n")


def generate_out_folder(out_folder: str, training_data_path: str,
                        div_path: str, method_name: str) -> str:
    path = training_data_path.strip("/").split("/")[-1]
    return os.path.join(out_folder, method_name, path, div_path,
                        time.strftime("%Y%m%d%H%M%S")) + "/"


EMBEDDING_FILES = ("ent_embeds", "nv_ent_embeds", "rv_ent_embeds",
                   "av_ent_embeds", "rel_embeds", "attr_embeds")
ID_FILES = ("kg1_ent_ids", "kg2_ent_ids", "kg1_rel_ids", "kg2_rel_ids",
            "kg1_attr_ids", "kg2_attr_ids")


def save_embeddings(folder: str, kgs, ent_embeds, nv_ent_embeds,
                    rv_ent_embeds, av_ent_embeds, rel_embeds,
                    attr_embeds) -> None:
    os.makedirs(folder, exist_ok=True)
    for name, arr in zip(EMBEDDING_FILES, (ent_embeds, nv_ent_embeds,
                                           rv_ent_embeds, av_ent_embeds,
                                           rel_embeds, attr_embeds)):
        if arr is not None:
            np.save(os.path.join(folder, name + ".npy"), np.asarray(arr))
    for name, dic in zip(ID_FILES, (
            kgs.kg1.entities_id_dict, kgs.kg2.entities_id_dict,
            kgs.kg1.relations_id_dict, kgs.kg2.relations_id_dict,
            kgs.kg1.attributes_id_dict, kgs.kg2.attributes_id_dict)):
        dict2file(os.path.join(folder, name), dic)
    print("Embeddings saved!")


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

def _flat_paths(tree, prefix: str, path=()):
    """{key: tensor} over the leaves of a nested dict of tensors; an
    optimizer slot ('count', 'mu', ...) is named by its optax path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_paths(tree[k], prefix, path + (k,)))
        return out
    return {prefix + "/".join(OPTAX_SLOT_PATHS.get(p, f"['{p}']")
                              for p in path): tree}


def resume_seed(seed: int, epoch: int) -> int:
    """Generator seed of a run resumed after ``epoch`` (-1 for an
    interrupt checkpoint)."""
    entropy = [seed % 2 ** 32, epoch % 2 ** 32]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def save_checkpoint(path: str, params, opt_states, seed: int,
                    epoch: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: v.detach().cpu().numpy()
              for prefix, tree in (("params:", params), ("opt:", opt_states))
              for k, v in _flat_paths(tree, prefix).items()}
    arrays["rng_key"] = np.asarray([seed, epoch], np.int64)
    arrays["epoch"] = np.asarray(epoch)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, params, opt_states) -> int:
    """Copy a checkpoint's tables and accumulators into ``params`` and
    ``opt_states`` (same structure as at save time), in place. Returns the
    checkpoint's epoch."""
    with np.load(path, allow_pickle=False) as data:
        for prefix, tree in (("params:", params), ("opt:", opt_states)):
            for k, t in _flat_paths(tree, prefix).items():
                if k not in data:
                    raise KeyError(f"checkpoint {path} has no {k!r}")
                arr = data[k]
                if arr.shape != tuple(t.shape):
                    raise ValueError(f"{k}: checkpoint shape {arr.shape}, "
                                     f"model shape {tuple(t.shape)}")
                with torch.no_grad():
                    t.copy_(torch.as_tensor(arr, dtype=t.dtype))
        return int(data["epoch"])
