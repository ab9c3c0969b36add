"""Dense Adam, Adadelta and SGD with optax's math (counterpart of the
``optax.adam`` / ``optax.adadelta`` / ``optax.sgd`` states the JAX package's
streams keep when ``Config.optimizer`` is not "Adagrad").

Each update is a plain in-place function over a stream's variables (a dict
of tensors, conv scorers as nested dicts). ``torch.optim`` is not used: its
state would not map onto the JAX package's checkpoint layout, and its Adam
places epsilon and the bias correction differently. The states are dicts
whose slots carry optax's names:

  Adam      {"count": int32 scalar, "mu": tree, "nu": tree}
            b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected
  Adadelta  {"e_g": tree, "e_x": tree}   rho 0.9, eps 1e-6, no weight decay
  SGD       {}                           no momentum

As in the JAX package, an optimizer name other than "Adam" or "Adadelta"
(and "Adagrad", which the streams handle themselves) selects SGD.
``OPTAX_SLOT_PATHS`` gives each slot's place in the flattened optax chain
state, so checkpoints keep the JAX package's keys.
"""
from __future__ import annotations

from typing import Dict

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6

# slot -> its path in the flattened optax state: optax.adam is
# chain(scale_by_adam, scale_by_learning_rate), optax.adadelta is
# chain(add_decayed_weights, scale_by_adadelta, scale_by_learning_rate)
OPTAX_SLOT_PATHS = {"count": "[0]/.count", "mu": "[0]/.mu", "nu": "[0]/.nu",
                    "e_g": "[1]/.e_g", "e_x": "[1]/.e_x"}


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _pairs(*trees):
    """The leaves of equally shaped nested dicts, zipped."""
    if isinstance(trees[0], dict):
        for k in trees[0]:
            yield from _pairs(*(t[k] for t in trees))
    else:
        yield trees


def init_state(name: str, params: Dict) -> Dict:
    """The optimizer state of ``params`` (one stream's variables)."""
    if name == "Adam":
        device = next(_pairs(params))[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": _zeros(params), "nu": _zeros(params)}
    if name == "Adadelta":
        return {"e_g": _zeros(params), "e_x": _zeros(params)}
    return {}


def apply(name: str, params: Dict, state: Dict, grads: Dict, lr: float):
    """One step of optimizer ``name`` on ``params``, in place, with the
    gradients ``grads`` (same structure)."""
    if name == "Adam":
        count = state["count"]
        count.add_(1)
        steps = count.to(torch.float32)       # bias correction in float32
        bc1 = 1.0 - ADAM_B1 ** steps
        bc2 = 1.0 - ADAM_B2 ** steps
        for p, g, m, v in _pairs(params, grads, state["mu"], state["nu"]):
            m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
            v.copy_((1 - ADAM_B2) * torch.square(g) + ADAM_B2 * v)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
            p.sub_(lr * upd)
    elif name == "Adadelta":
        for p, g, e_g, e_x in _pairs(params, grads, state["e_g"],
                                     state["e_x"]):
            e_g.copy_((1 - ADADELTA_RHO) * torch.square(g)
                      + ADADELTA_RHO * e_g)
            upd = torch.sqrt(e_x + ADADELTA_EPS) / \
                torch.sqrt(e_g + ADADELTA_EPS) * g
            e_x.copy_((1 - ADADELTA_RHO) * torch.square(upd)
                      + ADADELTA_RHO * e_x)
            p.sub_(lr * upd)
    else:
        for p, g in _pairs(params, grads):
            p.sub_(lr * g)
    return params, state


def state_from_optax(state):
    """An optax chain state as numpy (a tuple of NamedTuple states, as
    ``jax.tree_util.tree_map(np.asarray, ...)`` leaves it) as the port's
    slot dict of numpy arrays: the fields of every part, merged."""
    if hasattr(state, "_fields"):
        return {f: getattr(state, f) for f in state._fields}
    out = {}
    for part in state:
        out.update(state_from_optax(part))
    return out
