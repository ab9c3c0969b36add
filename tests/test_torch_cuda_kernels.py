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


def _rank_twice(e1, gold, gidx, e2, r2):
    """Two kernel calls: each adds exactly one launch, and the outputs are
    bitwise equal (the cross-CTA merge does not depend on order)."""
    n = rk.launches
    first = rk.rank_count(e1, gold, gidx, e2, r2)
    assert rk.launches == n + 1
    second = rk.rank_count(e1, gold, gidx, e2, r2)
    assert rk.launches == n + 2
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return first


@pytest.mark.parametrize("csls", [False, True])
@pytest.mark.parametrize("d", [1, 13, 75, rk.MAX_DIM])
@pytest.mark.parametrize("n1,n2", [(50, 100), (300, 1000), (2000, 3000)])
def test_rank_count_decomposition_exact(dev, n1, n2, d, csls):
    """Row blocks and column tiles at every edge: n1 below one 128-row
    block and not a multiple of it, n2 below one 128-column tile and not a
    multiple of it, and (2000 x 3000: 384 tiles) more tiles than resident
    CTAs, so CTA ranges cross row blocks and split rows between CTAs. The
    entries are small integers, so every score is an exact integer in any
    summation order: kernel and plain version must agree exactly, on the
    many ties too. Half the rows get a gold below their gold column's own
    score, which only the gold-column exclusion keeps out of the count;
    row 0's maximum is duplicated in two column tiles."""
    rng = np.random.RandomState(n1 + d + int(csls))
    e1 = rng.randint(-3, 4, (n1, d)).astype(np.float32)
    e2 = rng.randint(-3, 4, (n2, d)).astype(np.float32)
    top = 3 * np.where(e1[0] >= 0, 1, -1).astype(np.float32)
    dup = (min(5, n2 - 1), n2 - 3)                      # both hold row 0's max
    e2[list(dup)] = top
    gidx = rng.randint(0, n2, n1).astype(np.int32)
    s = e1.astype(np.int64) @ e2.T.astype(np.int64)
    r2 = rng.randint(-8, 9, n2).astype(np.float32) if csls else None
    if csls:
        r2[list(dup)] = -8                              # keeps them the max
        s = 2 * s - r2.astype(np.int64)[None, :]
    gold = (s[np.arange(n1), gidx] - (np.arange(n1) % 2)).astype(np.float32)
    t = [torch.as_tensor(x, device=dev) for x in (e1, gold, gidx, e2)]
    rt = None if r2 is None else torch.as_tensor(r2, device=dev)
    c, bi, bv = _rank_twice(*t, rt)
    c2, bi2, bv2 = rk.rank_count_plain(*t, rt)
    assert torch.equal(c, c2)
    assert torch.equal(bi, bi2)
    assert torch.equal(bv, bv2)
    assert int(bi[0]) <= dup[0] and float(bv[0]) == float(s[0].max())


@pytest.mark.parametrize("csls", [False, True])
def test_rank_count_signed_zero_max(dev, csls):
    """A maximum of 0.0 from a column of -0.0 entries and from a later one
    of +0.0 entries, in the same tile and in two tiles: the earlier column
    wins, as in the plain version, because -0.0 and +0.0 are one value."""
    n2, d = 300, 8
    e1 = torch.eye(2, d, device=dev)
    e2 = -torch.ones(n2, d, device=dev)                 # every score -1 ...
    for row, (a, b) in enumerate([(5, 7), (6, 200)]):
        e2[a, row] = -0.0                               # ... but -0.0 here
        e2[b, row] = 0.0                                # ... and +0.0 here
    gold = torch.full((2,), -2.0, device=dev)
    gidx = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    r2 = torch.zeros(n2, device=dev) if csls else None
    c, bi, bv = _rank_twice(e1, gold, gidx, e2, r2)
    assert bi.tolist() == [5, 6]
    assert bv.tolist() == [0.0, 0.0]
    c2, bi2, _ = rk.rank_count_plain(e1, gold, gidx, e2, r2)
    assert torch.equal(c, c2) and torch.equal(bi, bi2)
