"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (the kernels are built at first
use); without one they skip. On a GPU machine (``--noconftest``: the shared
conftest imports JAX, which the port does not need):
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (K5_GRAD_TOL, K5_LOSS_RTOL, k5_errors, k5_grads,
                        k5_inputs)
from multike_tpu_torch import losses as tl
from multike_tpu_torch import params as tp
from multike_tpu_torch import sampling as ts
from multike_tpu_torch.config import Config
from multike_tpu_torch.kernels import apply_kernel as ak
from multike_tpu_torch.kernels import chunk_loss as ck
from multike_tpu_torch.kernels import conv_score as k4
from multike_tpu_torch.kernels import per_slot_loss as k5
from multike_tpu_torch.kernels import rank_kernel as rk
from multike_tpu_torch.train import streams as tst
from multike_tpu_torch.utils import profiling
from multike_tpu_torch.views import attr_conv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _k1_step(dev, E, d, N, seed, row_offset=0, hubs=(40, 2000)):
    """A table of rows [row_offset, row_offset + E) and one step's ids
    (below and above the table when row_offset > 0) with hub rows, made
    with numpy; returns card tensors."""
    rng = np.random.RandomState(seed)
    ids = [rng.randint(0, E + 2 * row_offset, N)]
    ids += [np.full(h, row_offset + (7 * k) % E) for k, h in enumerate(hubs)]
    ids = rng.permutation(np.concatenate(ids)).astype(np.int64)
    param = rng.randn(E, d).astype(np.float32)
    acc = (0.1 + rng.rand(E, d)).astype(np.float32)
    g_rows = rng.randn(len(ids), d).astype(np.float32)
    return [torch.tensor(x, device=dev) for x in (param, acc, ids, g_rows)]


def _k1_cpu(param, acc, ids, g_rows, lr, row_offset=0):
    p, a = param.cpu(), acc.cpu()
    ak.row_adagrad_plain(p, a, ids.cpu(), g_rows.cpu(), lr,
                         row_offset=row_offset)
    return p, a


@pytest.mark.parametrize("d,row_offset", [(75, 0), (384, 0), (1024, 0),
                                          (75, 1000)])
def test_row_adagrad_matches_plain(dev, d, row_offset):
    """Bitwise the CPU plain version, hub rows of 40 and 2,000 included;
    two launches bitwise equal (no deterministic-algorithms mode); rows the
    step does not touch untouched; the card's own plain version within
    rtol 2e-6 / atol 1e-7 on the rows of at most 32 occurrences. That
    version's ``index_add_`` sums with atomics in no fixed order, and on
    the hub rows the order moves a sum of 40 or 2,000 terms by more than
    that (1.7e-5 relative on the 2,000 hub's acc, NVIDIA H100 80GB HBM3)."""
    E, lr = 5000, 0.01
    param, acc, ids, g_rows = _k1_step(dev, E, d, 3000, d + row_offset,
                                       row_offset)
    outs = []
    for _ in range(2):
        p, a = param.clone(), acc.clone()
        n = ak.launches
        ak.row_adagrad(p, a, ids, g_rows, lr, row_offset=row_offset)
        assert ak.launches == n + 1
        outs.append((p, a))
    torch.cuda.synchronize()
    want_p, want_a = _k1_cpu(param, acc, ids, g_rows, lr, row_offset)
    for p, a in outs:
        assert torch.equal(p.cpu(), want_p) and torch.equal(a.cpu(), want_a)
    p2, a2 = param.clone(), acc.clone()
    ak.row_adagrad_plain(p2, a2, ids, g_rows, lr, row_offset=row_offset)
    local = ids - row_offset
    local = local[(local >= 0) & (local < E)]
    few = torch.bincount(local, minlength=E) <= 32
    torch.testing.assert_close(outs[0][0][few], p2[few], rtol=2e-6,
                               atol=1e-7)
    torch.testing.assert_close(outs[0][1][few], a2[few], rtol=2e-6,
                               atol=1e-7)
    touched = torch.zeros(E, dtype=torch.bool, device=dev)
    touched[local] = True
    assert torch.equal(outs[0][0][~touched], param[~touched])
    assert torch.equal(outs[0][1][~touched], acc[~touched])
    assert bool((outs[0][1][touched] != acc[touched]).any(1).all())


def test_row_adagrad_empty_steps_and_scratch(dev):
    """N = 0 and a step with no id in the shard leave the tables as they
    are; the kernel's per-row counters stay zero across tables of other
    sizes, so later steps still equal the CPU plain version."""
    d, lr = 75, 0.05
    param, acc, _, _ = _k1_step(dev, 300, d, 10, 1)
    p, a = param.clone(), acc.clone()
    n = ak.launches
    ak.row_adagrad(p, a, torch.zeros(0, dtype=torch.int64, device=dev),
                   torch.zeros(0, d, device=dev), lr)
    assert ak.launches == n                 # nothing to launch
    out = torch.tensor([0, 5, 9, 400, 401, 401], device=dev)
    ak.row_adagrad(p, a, out, torch.randn(6, d, device=dev), lr,
                   row_offset=10)
    torch.cuda.synchronize()
    assert torch.equal(p, param) and torch.equal(a, acc)
    for E, seed in ((5000, 2), (300, 3), (20000, 4), (5000, 5)):
        param, acc, ids, g_rows = _k1_step(dev, E, d, 4000, seed)
        p, a = param.clone(), acc.clone()
        ak.row_adagrad(p, a, ids, g_rows, lr)
        want_p, want_a = _k1_cpu(param, acc, ids, g_rows, lr)
        assert torch.equal(p.cpu(), want_p) and torch.equal(a.cpu(), want_a)


def test_row_adagrad_layouts(dev):
    """Ids as a column of a triple tensor (strided, as the attribute
    streams hand them over) and transposed gradient rows give the CPU
    plain version's bits; a strided table is refused (it is updated in
    place)."""
    param, acc, ids, g_rows = _k1_step(dev, 500, 75, 900, 6)
    triples = torch.stack([ids, ids + 1, ids], 1)
    p, a = param.clone(), acc.clone()
    ak.row_adagrad(p, a, triples[:, 0], g_rows.T.contiguous().T, 0.05)
    want_p, want_a = _k1_cpu(param, acc, ids, g_rows, 0.05)
    assert torch.equal(p.cpu(), want_p) and torch.equal(a.cpu(), want_a)
    with pytest.raises(ValueError):
        ak.row_adagrad(param.T.contiguous().T, acc, ids, g_rows, 0.1)


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


def _rank_twice(e1, gold, gidx, e2, r2, path=None):
    """Two kernel calls (``path``: a forced plan): each adds exactly one
    launch, and the outputs are bitwise equal (the cross-CTA merge does not
    depend on order)."""
    n = rk.launches
    first = rk.rank_count(e1, gold, gidx, e2, r2, _path=path)
    assert rk.launches == n + 1
    second = rk.rank_count(e1, gold, gidx, e2, r2, _path=path)
    assert rk.launches == n + 2
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return first


@pytest.mark.parametrize("csls", [False, True])
@pytest.mark.parametrize("d", [1, 13, 75, 352, 353, 512, 1024])
@pytest.mark.parametrize("n1,n2", [(50, 100), (300, 1000), (2000, 3000)])
def test_rank_count_decomposition_exact(dev, n1, n2, d, csls):
    """Row blocks and column tiles at every edge: n1 below one 128-row
    block and not a multiple of it, n2 below one 128-column tile and not a
    multiple of it, and (2000 x 3000: 384 tiles) more tiles than resident
    CTAs, so CTA ranges cross row blocks and split rows between CTAs; d on
    either plan, past the 352 the resident plan holds too. The entries are
    small integers, so every score is an exact integer in any summation
    order: kernel and plain version must agree exactly, on the many ties
    too. Half the rows get a gold below their gold column's own score,
    which only the gold-column exclusion keeps out of the count; row 0's
    maximum is duplicated in two column tiles."""
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


@pytest.mark.parametrize("path", [None, "streamed"])
@pytest.mark.parametrize("csls", [False, True])
def test_rank_count_signed_zero_max(dev, csls, path):
    """A maximum of 0.0 from a column of -0.0 entries and from a later one
    of +0.0 entries, in the same tile and in two tiles: the earlier column
    wins, as in the plain version, because -0.0 and +0.0 are one value. On
    the plan the kernel picks (resident at this d) and on the streamed
    one."""
    n2, d = 300, 8
    e1 = torch.eye(2, d, device=dev)
    e2 = -torch.ones(n2, d, device=dev)                 # every score -1 ...
    for row, (a, b) in enumerate([(5, 7), (6, 200)]):
        e2[a, row] = -0.0                               # ... but -0.0 here
        e2[b, row] = 0.0                                # ... and +0.0 here
    gold = torch.full((2,), -2.0, device=dev)
    gidx = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    r2 = torch.zeros(n2, device=dev) if csls else None
    c, bi, bv = _rank_twice(e1, gold, gidx, e2, r2, path)
    assert bi.tolist() == [5, 6]
    assert bv.tolist() == [0.0, 0.0]
    c2, bi2, _ = rk.rank_count_plain(e1, gold, gidx, e2, r2)
    assert torch.equal(c, c2) and torch.equal(bi, bi2)


@pytest.mark.parametrize("d,path", [(75, None), (75, "streamed"),
                                    (512, None)])
@pytest.mark.parametrize("csls", [False, True])
def test_rank_count_gold_outside_block(dev, csls, d, path):
    """The ring's call: a block of columns whose rows' gold columns lie in
    other blocks, as gold indices below 0 and from n2 on (``gold_idx -
    col0``). No column is excluded then, so every column that beats the
    gold counts; kernel and plain version agree exactly (integer scores),
    on either plan."""
    n1, n2 = 300, 700
    rng = np.random.RandomState(7 + int(csls))
    e1 = rng.randint(-3, 4, (n1, d)).astype(np.float32)
    e2 = rng.randint(-3, 4, (n2, d)).astype(np.float32)
    gidx = np.where(np.arange(n1) % 2 == 0, -rng.randint(1, 5000, n1),
                    n2 + rng.randint(0, 5000, n1)).astype(np.int32)
    s = e1.astype(np.int64) @ e2.T.astype(np.int64)
    r2 = rng.randint(-8, 9, n2).astype(np.float32) if csls else None
    if csls:
        s = 2 * s - r2.astype(np.int64)[None, :]
    gold = np.median(s, axis=1).astype(np.float32)
    t = [torch.as_tensor(x, device=dev) for x in (e1, gold, gidx, e2)]
    rt = None if r2 is None else torch.as_tensor(r2, device=dev)
    c, bi, bv = _rank_twice(*t, rt, path)
    c2, bi2, bv2 = rk.rank_count_plain(*t, rt)
    assert torch.equal(c, c2) and torch.equal(bi, bi2)
    assert torch.equal(bv, bv2)
    assert c.cpu().tolist() == (s > gold[:, None]).sum(1).tolist()


@pytest.mark.parametrize("csls", [False, True])
@pytest.mark.parametrize("d", [75, 128, 352])
def test_rank_count_plans_bitwise_equal(dev, d, csls):
    """Where both plans fit, the streamed plan's outputs are bitwise those
    of the resident plan on random (not integer) scores: both sum k in the
    same order with fmaf."""
    g = torch.Generator(device=dev).manual_seed(d)
    n1, n2 = 1000, 3000
    e1 = torch.randn(n1, d, device=dev, generator=g)
    e2 = torch.randn(n2, d, device=dev, generator=g)
    r2 = torch.rand(n2, device=dev, generator=g) if csls else None
    gold = (e1 * e2[:n1]).sum(1)
    gidx = torch.arange(n1, dtype=torch.int32, device=dev)
    res = _rank_twice(e1, gold, gidx, e2, r2, "resident")
    st = _rank_twice(e1, gold, gidx, e2, r2, "streamed")
    for a, b in zip(res, st):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert [rk.plan(n1, n2, d, csls, _path=p)["path"]
            for p in ("resident", "streamed")] == ["resident", "streamed"]


def test_rank_count_plan_choice(dev):
    """The kernel keeps d = 75 on the resident plan, two CTAs an SM; past
    352 only the streamed plan fits, two CTAs an SM at any d; forcing the
    resident plan there fails."""
    p75 = rk.plan(35_000, 70_000, 75)
    assert (p75["path"], p75["ctas_per_sm"], p75["waves"]) == ("resident", 2, 1)
    for d in (353, 512, 1024, 4096):
        p = rk.plan(35_000, 70_000, d)
        assert (p["path"], p["ctas_per_sm"], p["waves"]) == ("streamed", 2, 1)
    with pytest.raises(RuntimeError):
        rk.plan(1000, 1000, 353, _path="resident")


def _k3_inputs(dev, nc, s, c, d, masks, seed):
    """Unit rows of one KG's chunks and pools, and with ``masks`` a ragged
    positive mask (a padded tail in every chunk) and keep flags, made with
    numpy; card tensors ``(xs, kw)``."""
    rng = np.random.RandomState(seed)

    def rows(*shape):
        x = rng.randn(*shape, d).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    xs = [rows(nc, s), rows(nc, s), rows(nc, s), rows(nc, c), rows(nc, c)]
    kw = {}
    if masks:
        real = rng.randint(s // 2, s + 1, nc)
        kw = dict(pos_mask=(np.arange(s)[None] < real[:, None]),
                  keep_h=rng.rand(nc, s, c) > 0.01,
                  keep_t=rng.rand(nc, s, c) > 0.01)
    to = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    return [to(x) for x in xs], {k: to(v) for k, v in kw.items()}


def _k3_grads(xs, kw, w, scale):
    """The loss and the five gradients as the main path takes them: the
    wrapper's autograd Function on leaves, then the backward with the
    incoming gradient ``scale``."""
    leaves = [x.detach().requires_grad_() for x in xs]
    loss = ck.chunk_shared_loss(*leaves, neg_weight=w, **kw)
    grads = torch.autograd.grad(loss, leaves,
                                torch.tensor(scale, device=loss.device))
    return loss.detach(), grads


def _assert_k3_near_plain(xs, kw, w, scale, loss, grads):
    """The loss within rtol 1e-6 and every gradient within 2e-6 of its
    largest element of the plain version in float64 (gradients scaled by
    the incoming ``scale``)."""
    want_loss, want = ck.chunk_shared_loss_plain(
        *(x.double() for x in xs), neg_weight=w,
        **{k: v.double() for k, v in kw.items()})
    torch.testing.assert_close(loss.double(), want_loss, rtol=1e-6, atol=0)
    for name, x, got, g in zip(("phs", "prs", "pts", "cand_h", "cand_t"),
                               xs, grads, want):
        assert got.shape == x.shape, name
        g = scale * g
        err = float((got.double() - g).abs().max())
        assert err <= 2e-6 * float(g.abs().max()), (name, err)


@pytest.mark.parametrize("nc,s,c,d,masks", [
    (10, 4064, 128, 75, False),      # the chunk cell's first KG
    (10, 3937, 128, 75, True),       # its second, with masks
    (4, 1000, 128, 384, True),       # the ITC driver's width
    (2, 70, 200, 13, True),          # a pool over two tiles
])
def test_chunk_loss_matches_plain(dev, nc, s, c, d, masks):
    """K3 through the wrapper the main path calls (its autograd Function,
    then the backward with an incoming gradient of 0.37) against the plain
    version in float64 on the card: the loss within rtol 1e-6 and every
    gradient within 2e-6 of its largest element. The kernel is float32: its
    distances are rounded once (about 6e-8 of a distance up to 9), and a
    pool's gradient sums the terms of up to 4,064 positives, in float32
    within a 64-row tile and in float64 over the tiles; the CPU emulation
    of the kernel read 1.7e-7 of the largest element, the float32 plain
    version as much. Two calls, and the loss under ``torch.no_grad()``,
    give the same bits; each call launches once."""
    xs, kw = _k3_inputs(dev, nc, s, c, d, masks, nc * s + d)
    w, scale = 10 / 256, 0.37
    runs = []
    for _ in range(2):
        n = ck.launches
        runs.append(_k3_grads(xs, kw, w, scale))
        assert ck.launches == n + 1
    with torch.no_grad():
        loss_only = ck.chunk_shared_loss(*xs, neg_weight=w, **kw)
    torch.cuda.synchronize()
    (loss, grads), (loss2, grads2) = runs
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert torch.equal(loss_only, loss)
    _assert_k3_near_plain(xs, kw, w, scale, loss, grads)


def test_chunk_loss_takes_the_fault_plants_half_view(dev):
    """The half_batch fault's strided views (``a[:, :S // 2]``) through the
    loss's autograd: gradients of the views' shape, bitwise the result of
    contiguous copies, and near the plain version in float64 as in
    test_chunk_loss_matches_plain."""
    xs, kw = _k3_inputs(dev, 10, 4064, 128, 75, True, 7)
    half = [x[:, :2032] if i < 3 else x for i, x in enumerate(xs)]
    kw = {k: v[:, :2032] for k, v in kw.items()}
    assert not half[0].is_contiguous()
    results = []
    for args in (half, [x.contiguous() for x in half]):
        leaves = [x.detach().requires_grad_() for x in args]
        loss = tl.chunk_shared_relation_logistic_loss(*leaves, neg_weight=0.04,
                                                      **kw)
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l1, g1), (l2, g2) = results
    assert torch.equal(l1, l2)
    for a, b, x in zip(g1, g2, half):
        assert a.shape == x.shape and torch.equal(a, b)
    _assert_k3_near_plain(half, kw, 0.04, 1.0, l1, g1)


def test_chunk_loss_launches_once_a_kg_per_rel_view_step(dev):
    """One chunk-shared relation-view step on the card launches K3 once for
    each KG, on the dense and on the row-sparse path, and matches the CPU
    step (the plain version): the loss within rtol 1e-5; each table's
    Adagrad accumulator change, the squared gradient, within 1e-5 of its
    largest element; each table's change within 1e-5 of the largest
    gradient element times lr / sqrt(0.1), the most a step moves per unit
    of gradient from an accumulator of 0.1. The gradients' float32 sums
    differ in order (the gather's backward, K3's tiles, the apply's)."""
    E, R, d = 3000, 20, 75
    rng = np.random.RandomState(3)
    rng_t = lambda n, lo, hi: torch.as_tensor(np.stack(  # noqa: E731
        [rng.randint(lo, hi, n), rng.randint(0, R, n),
         rng.randint(lo, hi, n)], 1))
    t1, t2 = rng_t(5000, 0, 1500), rng_t(4000, 1500, 3000)
    for sparse in ("off", "on"):
        cfg = Config(dim=d, batch_size=2000, neg_triple_num=10,
                     neg_chunk_size=512, neg_pool_size=128,
                     learning_rate=0.01, row_sparse_updates=sparse)
        losses, changes, sq_grads = [], [], []
        for device in (dev, torch.device("cpu")):
            init = tp.init_params(cfg, E, R, 2, device="cpu")
            params = {k: init[k].to(device, copy=True)
                      for k in ("rv_ent", "rel")}
            opt = {k: torch.full_like(v, 0.1) for k, v in params.items()}
            epoch, _, _ = tst.build_rel_view_epoch(
                cfg, len(t1), len(t2), ((0, 1500), (1500, 3000)))
            gen = torch.Generator(device=dev).manual_seed(1)
            batch = [x[0] for x in epoch.draw(gen, t1.to(dev), t2.to(dev))]
            n = ck.launches
            losses.append(float(epoch.step(
                params, opt, *(x.to(device) for x in batch))))
            assert ck.launches == n + (2 if device.type == "cuda" else 0)
            changes.append({k: (params[k].cpu() - init[k]).double()
                            for k in params})
            sq_grads.append({k: opt[k].cpu().double() - 0.1 for k in opt})
        assert losses[0] == pytest.approx(losses[1], rel=1e-5)
        for k, want in sq_grads[1].items():
            top = float(want.max())
            assert top > 0, k
            err = float((sq_grads[0][k] - want).abs().max())
            assert err <= 1e-5 * top, (sparse, k, "squared gradient", err)
            err = float((changes[0][k] - changes[1][k]).abs().max())
            assert err <= 1e-5 * top ** 0.5 * cfg.learning_rate / 0.1 ** 0.5, \
                (sparse, k, "change", err)


def _assert_k5_near_plain(xs, head, kw, scale, loss, grads):
    """``chip_smoke.k5_errors`` within its tolerances: the loss within
    ``K5_LOSS_RTOL`` and every gradient within ``K5_GRAD_TOL`` of its
    largest element of the plain version in float64."""
    loss_err, grad_err = k5_errors(xs, head, kw, scale, loss, grads)
    assert loss_err <= K5_LOSS_RTOL, loss_err
    assert grad_err <= K5_GRAD_TOL, grad_err


@pytest.mark.parametrize("b,k,d,masks,coins", [
    (2539, 10, 75, True, "mixed"),   # the per-slot cell's first KG
    (2461, 10, 75, False, "mixed"),  # its second, without masks
    (2539, 10, 384, True, "mixed"),  # the ITC driver's wide width
    (300, 13, 1000, True, "mixed"),  # eight rounds of columns, two batches
    (100, 1, 8, True, "head"),
    (100, 10, 8, False, "tail"),
    (64, 10, 75, "all", "mixed"),    # every positive masked
    (1, 10, 75, True, "mixed"),
])
def test_per_slot_loss_matches_plain(dev, b, k, d, masks, coins):
    """K5 through the wrapper the main path calls (its autograd Function,
    then the backward with an incoming gradient of 0.37) against the plain
    version in float64 on the card: the loss within rtol 1e-6 and every
    gradient within 2e-6 of its largest element. The kernel is float32:
    each distance is rounded once (about 6e-8 of a distance up to 9) and a
    row's gradient sums at most K + 1 terms. Two calls, and the loss
    under ``torch.no_grad()``, give the same bits; each call launches
    once."""
    xs, head, kw = k5_inputs(dev, b, k, d, masks, b * k + d, coins)
    runs = []
    for _ in range(2):
        n = k5.launches
        runs.append(k5_grads(xs, head, kw, 0.37))
        assert k5.launches == n + 1
    with torch.no_grad():
        loss_only = k5.per_slot_loss(*xs, head, **kw)
    torch.cuda.synchronize()
    (loss, grads), (loss2, grads2) = runs
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert torch.equal(loss_only, loss)
    if masks == "all":
        assert float(loss) == 0.0 and not any(g.any() for g in grads)
    _assert_k5_near_plain(xs, head, kw, 0.37, loss, grads)


def test_per_slot_loss_takes_the_fault_plants_half_batch(dev):
    """The half_batch fault's first half (``a[:B // 2]``) through
    ``losses.lean_relation_logistic_loss``: gradients of the half's shape,
    bitwise the result of copies, near the plain version in float64 as in
    test_per_slot_loss_matches_plain; each call counts its slots,
    B // 2 x K, in ``loss.slot_pairs`` while a profiler session runs."""
    xs, head, kw = k5_inputs(dev, 2539, 10, 75, True, 7)
    half = [x[:1269] for x in xs]
    kw = {n: v[:1269] for n, v in kw.items()}
    results = []
    profiling.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        for args in (half, [x.clone() for x in half]):
            leaves = [x.detach().requires_grad_() for x in args]
            loss = tl.lean_relation_logistic_loss(*leaves, head[:1269], **kw)
            results.append((loss.detach(), torch.autograd.grad(loss,
                                                               leaves)))
    assert profiling.drain()["counters"] == {"loss.slot_pairs": 2 * 12690}
    (l1, g1), (l2, g2) = results
    assert torch.equal(l1, l2)
    for a, b, x in zip(g1, g2, half):
        assert a.shape == x.shape and torch.equal(a, b)
    _assert_k5_near_plain(half, head[:1269], kw, 1.0, l1, g1)


def test_per_slot_loss_launches_once_a_kg_per_rel_view_step(dev):
    """One per-slot relation-view step on the card (Bloom drop keep masks)
    launches K5 once for each KG, on the dense and on the row-sparse path,
    and matches the CPU step (the plain version), held as
    test_chunk_loss_launches_once_a_kg_per_rel_view_step holds K3's."""
    E, R, d = 3000, 20, 75
    rng = np.random.RandomState(4)
    rng_t = lambda n, lo, hi: torch.as_tensor(np.stack(  # noqa: E731
        [rng.randint(lo, hi, n), rng.randint(0, R, n),
         rng.randint(lo, hi, n)], 1))
    t1, t2 = rng_t(5000, 0, 1500), rng_t(4000, 1500, 3000)
    tfilter = ts.build_triple_filter(torch.cat([t1, t2]).numpy(),
                                     device=dev)
    for sparse in ("off", "on"):
        cfg = Config(dim=d, batch_size=2000, neg_triple_num=10,
                     neg_scheme="per_slot", learning_rate=0.01,
                     row_sparse_updates=sparse)
        losses, changes, sq_grads = [], [], []
        epoch, _, _ = tst.build_rel_view_epoch(
            cfg, len(t1), len(t2), ((0, 1500), (1500, 3000)),
            tfilter=tfilter)
        assert epoch.scheme == "per_slot"
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = [x[0] for x in epoch.draw(gen, t1.to(dev), t2.to(dev))]
        for device in (dev, torch.device("cpu")):
            init = tp.init_params(cfg, E, R, 2, device="cpu")
            params = {k: init[k].to(device, copy=True)
                      for k in ("rv_ent", "rel")}
            opt = {k: torch.full_like(v, 0.1) for k, v in params.items()}
            n = k5.launches
            losses.append(float(epoch.step(
                params, opt, *(x.to(device) for x in batch))))
            assert k5.launches == n + (2 if device.type == "cuda" else 0)
            changes.append({k: (params[k].cpu() - init[k]).double()
                            for k in params})
            sq_grads.append({k: opt[k].cpu().double() - 0.1 for k in opt})
        assert losses[0] == pytest.approx(losses[1], rel=1e-5)
        for k, want in sq_grads[1].items():
            top = float(want.max())
            assert top > 0, k
            err = float((sq_grads[0][k] - want).abs().max())
            assert err <= 1e-5 * top, (sparse, k, "squared gradient", err)
            err = float((changes[0][k] - changes[1][k]).abs().max())
            assert err <= 1e-5 * top ** 0.5 * cfg.learning_rate / 0.1 ** 0.5, \
                (sparse, k, "change", err)

def _k4_inputs(dev, B, d, seed):
    """A scorer with a non-trivial batch norm and biases, unit head and
    value rows, attribute rows at the attribute table's scale, a mask with
    a padded tail of 7 rows (none for one row) and an incoming gradient of
    the scores, made with numpy; card tensors."""
    rng = np.random.RandomState(seed)
    to = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa
    p = {k: v.to(dev) for k, v in tp.init_conv_params(
        torch.Generator().manual_seed(seed), d, "cpu").items()}
    p["bn_gamma"] = to(1 + 0.3 * rng.normal(size=d))
    for k in ("bn_beta", "conv0_b", "conv1_b", "dense_b"):
        p[k] = to(0.1 * rng.normal(size=p[k].shape))
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa
    rows = (to(unit(rng.normal(size=(B, d)))),
            to(0.1 * rng.normal(size=(B, d))),
            to(unit(rng.normal(size=(B, d)))))
    mask = to(np.arange(B) < max(B - 7, 1))
    return p, rows, mask, to(rng.uniform(-0.5, 0.5, size=B))


def _k4_grads(p, rows, mask, gs, score_fn=attr_conv.conv_score):
    """The scores and their gradients with respect to the rows and every
    parameter for the incoming gradient ``gs``, through the streams'
    ``conv_score`` (or ``score_fn``) and autograd's backward."""
    names = list(p)
    leaves = [x.detach().requires_grad_() for x in (*rows, *p.values())]
    score = score_fn(dict(zip(names, leaves[3:])), *leaves[:3], mask=mask)
    grads = torch.autograd.grad(score, leaves, gs)
    return [score.detach(), *grads]


@pytest.mark.parametrize("B,d", [(5000, 75), (4097, 75), (5000, 384),
                                 (1, 75)])
def test_conv_score_matches_plain(dev, B, d):
    """K4 through the streams' ``conv_score`` and autograd's backward
    against the plain version in float64 on the card: the scores and every
    gradient (rows and parameters) within 2e-5 of their largest element,
    or within twice the error of the plain version in float32 on the card
    (sums over up to 5,000 rows in float32: a bias's gradient cancels, and
    both orders err alike). Two calls give the same bits; each call
    launches the forward once."""
    p, rows, mask, gs = _k4_inputs(dev, B, d, B + d)
    runs = []
    for _ in range(2):
        n = k4.launches
        runs.append(_k4_grads(p, rows, mask, gs))
        assert k4.launches == n + 1
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    want_s, back = k4.conv_score_plain({k: x.double() for k, x in p.items()},
                                       *(x.double() for x in rows),
                                       mask.double())
    keys = ["h", "a", "v", *p]
    g64 = back(gs.double())
    want = [want_s] + [g64[k] for k in keys]
    s32, back32 = k4.conv_score_plain(p, *rows, mask)
    g32 = back32(gs)
    plain32 = [s32] + [g32[k] for k in keys]
    for name, got, w, f32 in zip(["score"] + keys, runs[0], want, plain32):
        assert got.shape == w.shape, name
        top = float(w.abs().max())
        err = float((got.double() - w).abs().max())
        err32 = float((f32.double() - w).abs().max())
        assert err <= max(2e-5 * top, 2 * err32), (name, err / top,
                                                  err32 / top)


@pytest.mark.parametrize("stream", ["attr_view", "ckga_attr"])
def test_conv_score_launches_once_a_cnn_step(dev, stream):
    """An attribute stream's epoch on the card launches K4's forward once
    a step, and under a profiler session its ``conv.kernel_rows`` equal
    the scorer's ``conv.rows``: every scored row ran the kernels."""
    from torch.profiler import ProfilerActivity, profile

    E, R, A, L, d = 3000, 10, 40, 800, 75
    cfg = Config(dim=d, batch_size=2000, attribute_batch_size=1500,
                 learning_rate=0.01, row_sparse_updates="on")
    rng = np.random.RandomState(5)
    params = tp.init_params(cfg, E, R, A, device=dev)
    opt = tst.init_stream_opt_states(cfg, params)[stream]
    lit = rng.normal(size=(L, d))
    constants = {"literal_embeds": torch.tensor(
        lit / np.linalg.norm(lit, axis=1, keepdims=True), dtype=torch.float32,
        device=dev)}

    def trips(n, lo, hi):
        return torch.tensor(np.stack([rng.randint(lo, hi, n),
                                      rng.randint(0, A, n),
                                      rng.randint(0, L, n)], 1), device=dev)

    def weights(n):
        return torch.tensor(rng.uniform(0.2, 1.0, n), dtype=torch.float32,
                            device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    if stream == "attr_view":
        epoch, steps, _ = tst.build_attr_view_epoch(cfg, 2500, 1900)
        args = (constants, trips(2500, 0, 1500), weights(2500),
                trips(1900, 1500, 3000), weights(1900))
        kw = {}
    else:
        epoch, steps, _ = tst.build_ckga_attr_epoch(cfg, 4100)
        args, kw = (trips(4100, 0, 3000), weights(4100)), dict(
            constants=constants)
    epoch(params, opt, gen, *args, **kw)
    profiling.drain()
    n = k4.launches
    with profile(activities=[ProfilerActivity.CPU]):
        epoch(params, opt, gen, *args, **kw)
        torch.cuda.synchronize()
    rec = profiling.drain()
    assert steps > 1 and k4.launches == n + steps
    counters = rec["counters"]
    assert counters["conv.kernel_rows"] == counters["conv.rows"] > 0
    assert rec["by_name"]["step.conv"]["count"] == steps


def test_conv_score_refuses_what_it_does_not_take(dev):
    """On the card the scorer takes two convolutions of 2 maps with TF's
    SAME padding at a width up to MAX_DIM, and raises for the rest before
    any launch."""
    p, rows, mask, _ = _k4_inputs(dev, 64, 75, 0)
    n = k4.launches
    with pytest.raises(ValueError, match="layer_num"):
        attr_conv.conv_score(p, *rows, layer_num=3)
    with pytest.raises(ValueError, match="SAME"):
        k4.scores(p, *rows, pad=(2, 1, 1, 0))
    three = {**p, "conv0_w": torch.zeros(2, 4, 1, 3, device=dev),
             "conv0_b": torch.zeros(3, device=dev)}
    with pytest.raises(ValueError, match="conv0"):
        attr_conv.conv_score(three, *rows)
    wide = torch.zeros(4, k4.MAX_DIM + 1, device=dev)
    with pytest.raises(ValueError, match="0 < d"):
        attr_conv.conv_score(p, wide, wide, wide)
    with pytest.raises(TypeError):
        attr_conv.conv_score(p, *(x.double() for x in rows))
    assert k4.launches == n
