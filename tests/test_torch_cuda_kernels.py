"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (the kernels are built at first
use); without one they skip. On a GPU machine (``--noconftest``: the shared
conftest imports JAX, which the port does not need):
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest``."""
import numpy as np
import pytest
import torch

from multike_tpu_torch.kernels import apply_kernel as ak
from multike_tpu_torch.kernels import rank_kernel as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_fused_row_adagrad_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    E, d, N = 5000, 75, 3000
    param = torch.randn(E, d, device=dev, generator=g)
    acc = torch.rand(E, d, device=dev, generator=g) + 0.1
    u = torch.unique(torch.randint(0, E, (N,), device=dev, generator=g))
    loc = torch.cat([u, E + torch.arange(N - len(u), device=dev)]).int()
    gsum = torch.randn(N, d, device=dev, generator=g)
    p1, a1 = param.clone(), acc.clone()
    p2, a2 = param.clone(), acc.clone()
    n = ak.launches
    ak.fused_row_adagrad(p1, a1, loc, gsum, 0.01)
    assert ak.launches == n + 1
    ak.fused_row_adagrad_plain(p2, a2, loc, gsum, 0.01)
    torch.cuda.synchronize()
    torch.testing.assert_close(p1, p2, rtol=2e-6, atol=1e-7)
    torch.testing.assert_close(a1, a2, rtol=2e-6, atol=1e-7)
    untouched = torch.ones(E, dtype=torch.bool, device=dev)
    untouched[u] = False
    assert torch.equal(p1[untouched], param[untouched])


@pytest.mark.parametrize("csls", [False, True])
def test_rank_count_matches_plain(dev, csls):
    g = torch.Generator(device=dev).manual_seed(1)
    n1, n2, d = 1000, 2100, 75
    e1 = torch.nn.functional.normalize(
        torch.randn(n1, d, device=dev, generator=g), dim=1)
    e2 = torch.nn.functional.normalize(
        torch.randn(n2, d, device=dev, generator=g), dim=1)
    r2 = torch.rand(n2, device=dev, generator=g) if csls else None
    gold = (e1 * e2[:n1]).sum(1)
    if csls:
        gold = 2 * gold - r2[:n1]
    gidx = torch.arange(n1, dtype=torch.int32, device=dev)
    n = rk.launches
    c, bi, bv = rk.rank_count(e1, gold, gidx, e2, r2)
    assert rk.launches == n + 1
    c2, bi2, bv2 = rk.rank_count_plain(e1, gold, gidx, e2, r2)
    torch.cuda.synchronize()
    # a disagreement is allowed only where a competing score ties its gold
    # to 1e-6 (counts), or where the two argmax columns score within 1e-6
    # (argmax); the gold column itself is not counted, so it is masked
    s = e1 @ e2.T
    if csls:
        s = 2 * s - r2[None, :]
    rows = torch.arange(n1, device=dev)
    s_rest = s.clone()
    s_rest[rows, gidx.long()] = float("inf")
    near = ((s_rest - gold[:, None]).abs() < 1e-6).any(1)
    assert int(near.sum()) < n1 // 10, "too many tie rows for the check"
    assert not ((c != c2) & ~near).any()
    tie = (s.gather(1, bi.long()[:, None]) -
           s.gather(1, bi2[:, None].long())).abs()[:, 0] < 1e-6
    assert not ((bi != bi2) & ~tie).any()
    np.testing.assert_allclose(bv.cpu().numpy(), bv2.cpu().numpy(),
                               atol=1e-5)
