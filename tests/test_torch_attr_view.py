"""The port's attribute-view conv scorer against the JAX package's (CPU),
with the conv parameters copied across: every stage of ``conv_stages``
(rtol 1e-5 / atol 1e-6) and the gradients of a weighted score sum with
respect to every parameter and input (rtol 1e-5 / atol 1e-6), with and
without a row mask."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multike_tpu import params as jp
from multike_tpu.config import Config as JConfig
from multike_tpu.views import attr_conv as jconv
from multike_tpu_torch import params as tp
from multike_tpu_torch.views import attr_conv as tconv

TOL = dict(rtol=1e-5, atol=1e-6)
B, DIM = 12, 10


def _inputs(masked):
    rng = np.random.RandomState(3)
    conv = {k: np.asarray(v) for k, v in
            jp.init_params(JConfig(dim=DIM), 4, 2, 3)["conv_av"].items()}
    # non-trivial batch norm and biases
    conv["bn_gamma"] = (1 + 0.3 * rng.normal(size=DIM)).astype(np.float32)
    conv["bn_beta"] = (0.1 * rng.normal(size=DIM)).astype(np.float32)
    for k in ("conv0_b", "conv1_b", "dense_b"):
        conv[k] = (0.1 * rng.normal(size=conv[k].shape)).astype(np.float32)
    h, a, v = (rng.normal(size=(B, DIM)).astype(np.float32)
               for _ in range(3))
    h = h / np.linalg.norm(h, axis=1, keepdims=True)
    mask = (np.arange(B) < B - 4).astype(np.float32) if masked else None
    r = rng.normal(size=B).astype(np.float32)
    return conv, h, a, v, mask, r


@pytest.mark.parametrize("masked", [False, True])
def test_conv_stages_match_jax(masked):
    conv, h, a, v, mask, _ = _inputs(masked)
    want = jconv.conv_stages({k: jnp.asarray(x) for k, x in conv.items()},
                             jnp.asarray(h), jnp.asarray(a), jnp.asarray(v),
                             mask=None if mask is None else jnp.asarray(mask))
    got = tconv.conv_stages(tp.params_from_reference(conv, device="cpu"),
                            torch.tensor(h), torch.tensor(a), torch.tensor(v),
                            mask=None if mask is None else torch.tensor(mask))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_conv_score_gradients_match_jax(masked):
    conv, h, a, v, mask, r = _inputs(masked)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(p, hh, aa, vv):
        return jnp.sum(jconv.conv_score(p, hh, aa, vv, mask=jm) * r)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        {k: jnp.asarray(x) for k, x in conv.items()}, jnp.asarray(h),
        jnp.asarray(a), jnp.asarray(v))

    tconv_p = {k: torch.tensor(x, requires_grad=True)
               for k, x in conv.items()}
    th, ta, tv = (torch.tensor(x, requires_grad=True) for x in (h, a, v))
    tm = None if mask is None else torch.tensor(mask)
    loss = torch.sum(tconv.conv_score(tconv_p, th, ta, tv, mask=tm)
                     * torch.tensor(r))
    loss.backward()
    for k in conv:
        np.testing.assert_allclose(tconv_p[k].grad.numpy(),
                                   np.asarray(jgrads[0][k]), **TOL,
                                   err_msg=k)
    for name, t, g in (("h", th, jgrads[1]), ("a", ta, jgrads[2]),
                       ("v", tv, jgrads[3])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=name)
    if masked:       # a padded row's attribute and value change nothing
        assert float(ta.grad[mask == 0].abs().max()) == 0.0
        assert float(tv.grad[mask == 0].abs().max()) == 0.0
