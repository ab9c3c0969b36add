#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``multike_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-of DIR   # phases 1 and 3 only, for the
                                        # package under DIR (for example an
                                        # earlier commit, from git archive)

Phases, each of which must pass or the script exits non-zero:

  1. build the CUDA kernels from ``multike_tpu_torch/csrc`` (timed), and
     report each one's registers and spills (a spill fails the run);
  2. K1, the fused row-sparse Adagrad apply, against its plain PyTorch
     version at the per-step shape of bench.py (200K x 75 table, the ids of
     one batch-80000 chunk_shared step);
  3. K2, the fused rank count, against its plain version at 35K x 70K,
     d=75, and at the main path's own 6K x 6K and 2K x 8K, then in CSLS
     form; at each shape it is timed beside the plain version and
     ``torch.matmul`` alone, with its bound and launch geometry;
  4. the main path: ``MultiKETrainer`` trains the relation view on the
     port's synthetic 20K-entity KG pair and ``views.valid_metrics`` ranks
     it; the rv valid MRR must rise and both kernels must have launched;
  5. relation-view throughput at bench.py's shape (100K entities and 600K
     random triples per KG, batch 80000).

It then prints one ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi reports them, and last ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the package beside it, it fails.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of each H100 part, keyed by the name nvidia-smi gives it
# (NVIDIA's data sheets, at the part's full power limit): device memory
# bytes/s and float32 FLOP/s outside the tensor cores. Each bound below is
# the larger of bytes over the first and operations over the second. A card
# this table does not know fails the run, so no bound is taken from the
# peaks of another part.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),      # SXM5
    "NVIDIA H100 NVL": (3.9e12, 60e12),
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def card_peaks(card: str):
    """(bytes/s, fp32 FLOP/s) of the card named first in ``card``."""
    name = card.split(",")[0].strip()
    check(name in PEAKS, f"no published peaks for {name!r}: add its data "
          "sheet's memory rate and fp32 rate to PEAKS")
    return PEAKS[name]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clocks_under_load(run, calls: int) -> dict:
    """Runs ``run`` ``calls`` times back to back while nvidia-smi samples
    the SM clock, its maximum and the power draw every 100 ms; returns the
    medians of the samples taken inside the run."""
    import datetime
    import statistics

    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,clocks.max.sm,"
         "power.draw", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(1.0)
        run()
        torch.cuda.synchronize()
        start = datetime.datetime.now() + datetime.timedelta(seconds=0.2)
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        end = datetime.datetime.now()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = []
    for ln in out.splitlines():
        f = [x.strip() for x in ln.split(",")]
        try:
            at = datetime.datetime.strptime(f[0], "%Y/%m/%d %H:%M:%S.%f")
            sample = (float(f[1]), float(f[2]), float(f[3]))
        except (ValueError, IndexError):
            continue
        if start <= at <= end:
            samples.append(sample)
    check(samples, "nvidia-smi took no sample during the run")
    return dict(samples=len(samples),
                sm_mhz=statistics.median(x[0] for x in samples),
                max_sm_mhz=max(x[1] for x in samples),
                power_w=statistics.median(x[2] for x in samples))


def bench_triples(rng, n_triples, ent_lo, ent_hi, n_rel, rel_lo):
    """bench.py's random triples: uniform heads, relations and tails."""
    import numpy as np

    h = rng.randint(ent_lo, ent_hi, size=n_triples)
    r = rng.randint(rel_lo, rel_lo + n_rel, size=n_triples)
    t = rng.randint(ent_lo, ent_hi, size=n_triples)
    return np.stack([h, r, t], axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Build the kernels and report each one's registers and spills from
    nvcc's ``-Xptxas -v`` log; a kernel that spills fails the run."""
    from multike_tpu_torch.kernels import _build

    t0 = time.time()
    path = _build.build()
    _build.load()
    secs = time.time() - t0
    log(f"[build] kernels built and loaded in {secs:.2f} s: "
        f"{os.path.relpath(path, REPO)}")
    kernels, name = {}, None
    with open(path + ".log") as f:
        for ln in f:
            if "Compiling entry function" in ln:
                name = ln.split("'")[1]
                kernels[name] = {}
            elif name and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
                kernels[name]["spill_bytes"] = int(m[1]) + int(m[2])
            elif name and (m := re.search(r"Used (\d+) registers", ln)):
                kernels[name]["registers"] = int(m[1])
    check(kernels, "the nvcc log names no kernel")
    for name, info in kernels.items():
        log(f"[build]   {name[:72]}: {info.get('registers')} registers, "
            f"{info.get('spill_bytes')} spill bytes")
        check(info.get("spill_bytes") == 0, f"{name} spills to local memory")


def phase_apply(dev, peaks, n_ent=100_000, batch=80_000, rel_triples=600_000,
                seed=0):
    """K1 against its plain version on the ids of one bench.py step."""
    import numpy as np
    import torch

    from multike_tpu_torch.config import Config
    from multike_tpu_torch.kernels import apply_kernel as ak
    from multike_tpu_torch.train import sparse_adagrad, streams

    rng = np.random.RandomState(seed)
    t1 = torch.as_tensor(bench_triples(rng, rel_triples, 0, n_ent, 500, 0),
                         device=dev)
    t2 = torch.as_tensor(bench_triples(rng, rel_triples, n_ent, 2 * n_ent,
                                       500, 500), device=dev)
    cfg = Config(dim=75, batch_size=batch, neg_triple_num=10)
    epoch, _, _ = streams.build_rel_view_epoch(
        cfg, rel_triples, rel_triples, ((0, n_ent), (n_ent, 2 * n_ent)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [x[0] for x in epoch.draw(gen, t1, t2)]
    ids, _ = epoch._prep(*xs)
    ids = ids["rv_ent"]
    E, d, N = 2 * n_ent, cfg.dim, ids.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    param = torch.randn(E, d, device=dev, generator=g)
    acc = torch.rand(E, d, device=dev, generator=g) + 0.1
    g_rows = torch.randn(N, d, device=dev, generator=g)
    loc, gsum = sparse_adagrad.dedup_rows(ids, g_rows, E)
    gsum = gsum.contiguous()
    U = int(torch.unique(ids).numel())
    check(U < N, "the step's ids should hold duplicates")

    p_k, a_k = param.clone(), acc.clone()
    p_p, a_p = param.clone(), acc.clone()
    ak.fused_row_adagrad(p_k, a_k, loc, gsum, 0.001)
    ak.fused_row_adagrad_plain(p_p, a_p, loc, gsum, 0.001)
    torch.cuda.synchronize()
    err = max(float((p_k - p_p).abs().max()), float((a_k - a_p).abs().max()))
    for got, want, name in ((p_k, p_p, "param"), (a_k, a_p, "acc")):
        bad = (got - want).abs() > 1e-7 + 2e-6 * want.abs()
        check(not bool(bad.any()), f"K1 {name}: {int(bad.sum())} elements "
              "outside rtol 2e-6 / atol 1e-7")
    touched = torch.zeros(E, dtype=torch.bool, device=dev)
    touched[ids] = True
    check(torch.equal(p_k[~touched], param[~touched]) and
          torch.equal(a_k[~touched], acc[~touched]),
          "K1 changed rows the step does not touch")
    check(bool((a_k[touched] != acc[touched]).any(dim=1).all()),
          "K1 left a touched row's accumulator unchanged")
    sentinels = int((loc >= E).sum())
    check(sentinels == N - U, "dedup sentinel count")

    ms = time_ms(lambda: ak.fused_row_adagrad(p_k, a_k, loc, gsum, 0.001), 20)
    plain_ms = time_ms(
        lambda: ak.fused_row_adagrad_plain(p_p, a_p, loc, gsum, 0.001), 5)
    # read param, acc and gsum rows and write param and acc rows once per
    # unique id, plus the ids; about 7 operations per element
    nbytes = U * d * 4 * 5 + 4 * N
    flops = 7.0 * U * d
    mem_rate, fp32_rate = peaks
    bound_ms = max(nbytes / mem_rate, flops / fp32_rate) * 1e3
    log(f"[K1] E={E} d={d} ids={N} unique={U} sentinels={sentinels}: "
        f"max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"{mem_rate / 1e12:.2f} TB/s)")
    return dict(name="fused_row_adagrad", route="cuda",
                source="multike_tpu_torch/csrc/apply_kernel.cu",
                replaces="multike_tpu/kernels/apply_kernel.py:144",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                shape=dict(E=E, d=d, ids=N, unique=U))


def _rank_inputs(dev, n1, n2, d, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    e1 = torch.randn(n1, d, device=dev, generator=g)
    e2 = torch.randn(n2, d, device=dev, generator=g)
    e2[:n1] += 0.5 * e1                     # aligned pairs, nonzero ranks
    e1 = e1 / e1.norm(dim=1, keepdim=True)
    e2 = e2 / e2.norm(dim=1, keepdim=True)
    return e1.contiguous(), e2.contiguous()


def _rank_compare(e1, e2, gold, r2, got, want):
    """(count mismatches, argmax mismatches, rows near a tie). A mismatch is
    allowed only on a row where a competing score lies within 1e-6 of its
    gold (count) or of its best score (argmax)."""
    import torch

    c_bad = torch.nonzero(got[0] != want[0]).flatten()
    i_bad = torch.nonzero(got[1] != want[1]).flatten()
    rows = torch.unique(torch.cat([c_bad, i_bad]))
    for i in rows.tolist():
        s = e1[i] @ e2.T
        if r2 is not None:
            s = 2 * s - r2
        near_best = int(((s - s.max()).abs() <= 1e-6).sum()) > 1
        s[i] = float("inf")                 # the gold column is not counted
        near_gold = bool(((s - gold[i]).abs() <= 1e-6).any())
        check(near_gold or near_best,
              f"K2 row {i}: count {int(got[0][i])} vs {int(want[0][i])}, "
              f"argmax {int(got[1][i])} vs {int(want[1][i])} with no tie")
    return int(c_bad.numel()), int(i_bad.numel()), int(rows.numel())


# K2's shapes: DWY100K's test size, then the 20K main path's own test and
# validation (data/synthetic.py's 6/1/3 split of 20,000 links: 6,000 x 6,000
# and 2,000 x (2,000 + 6,000)), each with its timing repetitions.
RANK_SHAPES = ((35_000, 70_000, 5), (6_000, 6_000, 20), (2_000, 8_000, 20))


def _rank_twice(rk, *args):
    """Two kernel calls, which must return bitwise-equal outputs."""
    import torch

    first = rk.rank_count(*args)
    second = rk.rank_count(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(first, second)),
          "K2 returned different outputs for the same inputs")
    return first


def _rank_shape(dev, peaks, n1, n2, d, reps, seed, clock_calls=0):
    """K2 at one shape: tie-only mismatches against the plain version,
    bitwise-equal repeats, and the times of the kernel, the plain version
    and ``torch.matmul`` alone beside the bound. With ``clock_calls``, the
    SM clock under a sustained run of the kernel, and the share of the
    FFMA issue slots at that clock that the kernel's products fill."""
    import torch

    from multike_tpu_torch.kernels import rank_kernel as rk

    e1, e2 = _rank_inputs(dev, n1, n2, d, seed)
    gold = (e1 * e2[:n1]).sum(1)
    gidx = torch.arange(n1, dtype=torch.int32, device=dev)
    got = _rank_twice(rk, e1, gold, gidx, e2)
    want = rk.rank_count_plain(e1, gold, gidx, e2)
    torch.cuda.synchronize()
    c_mis, i_mis, ties = _rank_compare(e1, e2, gold, None, got, want)
    err = float((got[2] - want[2]).abs().max())

    ms = time_ms(lambda: rk.rank_count(e1, gold, gidx, e2), reps)
    plain_ms = time_ms(lambda: rk.rank_count_plain(e1, gold, gidx, e2),
                       max(3, reps // 4))
    library_ms = time_ms(lambda: torch.matmul(e1, e2.T), max(3, reps // 2))
    flops = 2.0 * n1 * n2 * d
    nbytes = (n1 + n2) * d * 4 + n1 * 8 + n1 * 12
    mem_rate, fp32_rate = peaks
    bound_ms = max(flops / fp32_rate, nbytes / mem_rate) * 1e3
    # (an earlier version of the package, under --k2-of, may have no plan)
    geo = rk.plan(n1, n2, d, device=dev) if hasattr(rk, "plan") else {}
    if clock_calls:
        clk = clocks_under_load(lambda: rk.rank_count(e1, gold, gidx, e2),
                                clock_calls)
        clk["ffma_slot_share"] = (flops / ms / 1e9) / (
            fp32_rate / 1e12 * clk["sm_mhz"] / clk["max_sm_mhz"])
        geo["clock"] = clk
    log(f"[K2] {n1}x{n2} d={d}: kernel {ms:.4f} ms = "
        f"{flops / ms / 1e9:.2f} TFLOP/s = {100 * bound_ms / ms:.1f}% of the "
        f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP at "
        f"{fp32_rate / 1e12:.0f} TFLOP/s fp32); plain {plain_ms:.4f} ms; "
        f"torch.matmul alone {library_ms:.4f} ms")
    if "tiles" in geo:
        log(f"[K2]   {geo['tiles']} tiles of 128x128 on {geo['ctas']} CTAs "
            f"({geo['resident']} resident slots, {geo['waves']} wave, "
            f"{geo['tiles_per_cta_min']}-{geo['tiles_per_cta_max']} tiles "
            f"per CTA, {geo['smem']} B shared memory each)")
    log(f"[K2]   count mismatches {c_mis}, "
        f"argmax mismatches {i_mis}, all on {ties} rows within 1e-6 of a "
        f"tie; best_val max_abs_err {err:.3e}; mean rank "
        f"{float(got[0].float().mean()):.2f}")
    if clock_calls:
        log(f"[K2]   under {clock_calls} back-to-back calls: SM clock "
            f"{clk['sm_mhz']:.0f} of {clk['max_sm_mhz']:.0f} MHz at "
            f"{clk['power_w']:.1f} W ({clk['samples']} samples), so the "
            f"products fill {100 * clk['ffma_slot_share']:.1f}% of the FFMA "
            "issue slots at that clock")
    return dict(n1=n1, n2=n2, d=d, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_share=bound_ms / ms, tflops=flops / ms / 1e9,
                max_abs_err=err, count_mismatches=c_mis,
                argmax_mismatches=i_mis, tie_rows=ties, **geo)


def phase_rank(dev, peaks, d=75, csls_n=(5_000, 10_000), csls_k=10):
    """K2 at each of RANK_SHAPES, then in CSLS form."""
    import torch

    from multike_tpu_torch.eval.similarity import csls_penalties_blockwise
    from multike_tpu_torch.kernels import rank_kernel as rk

    shapes = [_rank_shape(dev, peaks, n1, n2, d, reps, seed,
                          clock_calls=200 if seed == 0 else 0)
              for seed, (n1, n2, reps) in enumerate(RANK_SHAPES)]

    c1, c2 = _rank_inputs(dev, csls_n[0], csls_n[1], d, len(RANK_SHAPES))
    _, r2 = csls_penalties_blockwise(c1, c2, csls_k)
    cg = 2 * (c1 * c2[:csls_n[0]]).sum(1) - r2[:csls_n[0]]
    cidx = torch.arange(csls_n[0], dtype=torch.int32, device=dev)
    cgot = _rank_twice(rk, c1, cg, cidx, c2, r2)
    cwant = rk.rank_count_plain(c1, cg, cidx, c2, r2)
    torch.cuda.synchronize()
    cc, ci, ct = _rank_compare(c1, c2, cg, r2, cgot, cwant)
    cerr = float((cgot[2] - cwant[2]).abs().max())
    log(f"[K2] CSLS k={csls_k} {csls_n[0]}x{csls_n[1]}: count mismatches "
        f"{cc}, argmax mismatches {ci}, on {ct} tie rows")

    big = shapes[0]
    return dict(name="rank_count", route="cuda",
                source="multike_tpu_torch/csrc/rank_kernel.cu",
                replaces="multike_tpu/kernels/rank_kernel.py:112",
                max_abs_err=max([cerr] + [x["max_abs_err"] for x in shapes]),
                ms=big["ms"], plain_ms=big["plain_ms"],
                bound_ms=big["bound_ms"], bound_by="operations",
                library_ms=big["library_ms"],
                count_mismatches=cc + sum(x["count_mismatches"] for x in shapes),
                argmax_mismatches=ci + sum(x["argmax_mismatches"]
                                           for x in shapes),
                tie_rows=ct + sum(x["tie_rows"] for x in shapes),
                shape=dict(n1=big["n1"], n2=big["n2"], d=d), shapes=shapes)


class _Data:
    """What this slice's trainer reads of a data model: the KG pair."""

    def __init__(self, kgs):
        self.kgs = kgs


def phase_main_path(dev, n=20_000, epochs=4, dim=75, batch=5000):
    """Train through MultiKETrainer on the synthetic pair and evaluate
    through views.valid_metrics; returns the kernels' launch counts."""
    from multike_tpu_torch.config import Config
    from multike_tpu_torch.data import synthetic
    from multike_tpu_torch.data.kg import read_kgs_from_folder
    from multike_tpu_torch.eval import views
    from multike_tpu_torch.kernels import apply_kernel as ak
    from multike_tpu_torch.kernels import rank_kernel as rk
    from multike_tpu_torch.train.trainer import MultiKETrainer

    t0 = time.time()
    folder = synthetic.generate(
        os.path.join(REPO, "output", "chip_smoke", f"syn{n}") + "/", seed=11,
        n_entities=n, n_relations=max(8, n // 100),
        n_attributes=max(6, n // 500), n_rel_triples=6 * n,
        n_attr_triples=3 * n)
    kgs = read_kgs_from_folder(folder, "631/", "swapping", False)
    cfg = Config(training_data=folder, dim=dim, batch_size=batch,
                 neg_triple_num=10, learning_rate=0.01,
                 row_sparse_updates=True, use_pallas_apply=True)
    log(f"[main] {n} entities per KG, data ready in {time.time() - t0:.1f} s")

    ak.launches = 0
    rk.launches = 0
    trainer = MultiKETrainer(cfg, _Data(kgs), verbose=True, device=dev)
    _, before = views.valid_metrics(trainer, "rv")
    sup = kgs.kg1.sup_relation_triples_list + kgs.kg2.sup_relation_triples_list
    t0 = time.time()
    for ep in range(1, epochs + 1):
        loss = trainer.train_relation_view_1epo(ep)
        check(loss == loss and abs(loss) < 1e6, f"rel_view loss {loss}")
        trainer.train_cross_kg_entity_inference_relation_view_1epo(ep, sup)
    train_s = time.time() - t0
    hits1, after = views.valid_metrics(trainer, "rv")
    launches = {"fused_row_adagrad": ak.launches, "rank_count": rk.launches}
    emb = trainer.current_embeds_device("rv")
    check(tuple(emb.shape) == (kgs.entities_num, dim)
          and bool(emb.isfinite().all()), "rv embeddings not finite")
    log(f"[main] rv valid MRR {before:.4f} -> {after:.4f} (hits@1 {hits1}%) "
        f"after {epochs} epochs in {train_s:.1f} s; launches {launches}")
    check(after > before, f"rv valid MRR did not rise: {before} -> {after}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel did not launch on the main path: {launches}")
    check_against_cpu(trainer, emb)
    return launches


def check_against_cpu(trainer, emb):
    """The trained state, run once more on the card and on the CPU (the
    kernels' plain versions): one rel_view step from the same parameters
    and injected inputs must agree to rtol 3e-5 / atol 1e-6, and the valid
    ranks must be equal."""
    import numpy as np
    import torch

    from multike_tpu_torch.eval.alignment import rank_and_align
    from multike_tpu_torch.train import streams

    kgs = trainer.kgs
    ids1 = torch.as_tensor(kgs.valid_entities1, device=emb.device)
    ids2 = torch.as_tensor(kgs.valid_entities2 + kgs.test_entities2,
                           device=emb.device)
    card = rank_and_align(emb[ids1], emb[ids2])
    host = rank_and_align(emb[ids1].cpu(), emb[ids2].cpu())
    check(all(np.array_equal(a, b) for a, b in zip(card, host)),
          "valid ranks on the card differ from the CPU's")

    epoch, _, _ = streams.build_rel_view_epoch(
        trainer.cfg, trainer.n_rel1, trainer.n_rel2, trainer.ranges)
    xs = [x[0] for x in epoch.draw(trainer.gen, trainer.rel_triples1,
                                   trainer.rel_triples2)]
    out = {}
    for dev in (emb.device, torch.device("cpu")):
        params = {k: trainer.params[k].to(dev, copy=True)
                  for k in ("rv_ent", "rel")}
        acc = {k: trainer.opt_states["rel_view"][k].to(dev, copy=True)
               for k in ("rv_ent", "rel")}
        loss = epoch.step(params, acc, *(x.to(dev) for x in xs))
        out[dev.type] = (float(loss), params, acc)
    (l_card, p_card, a_card), (l_cpu, p_cpu, a_cpu) = out["cuda"], out["cpu"]
    worst = 0.0
    for k in ("rv_ent", "rel"):
        for got, want in ((p_card[k].cpu(), p_cpu[k]), (a_card[k].cpu(),
                                                         a_cpu[k])):
            excess = (got - want).abs() - (1e-6 + 3e-5 * want.abs())
            worst = max(worst, float(excess.max()))
    check(worst <= 0 and abs(l_card - l_cpu) <= 3e-5 * abs(l_cpu),
          f"a rel_view step on the card differs from the CPU's: loss "
          f"{l_card} vs {l_cpu}, worst excess over tolerance {worst:.3e}")
    log(f"[main] card vs CPU: valid ranks equal; one rel_view step agrees "
        f"(loss {l_card:.6f} vs {l_cpu:.6f})")


def phase_throughput(dev, card, n_ent=100_000, batch=80_000, epochs=10):
    """rel_view epochs at bench.py's shape (row-sparse, so through K1)."""
    import numpy as np
    import torch

    from multike_tpu_torch.config import Config
    from multike_tpu_torch.kernels import apply_kernel as ak
    from multike_tpu_torch.params import init_params
    from multike_tpu_torch.train import streams

    rng = np.random.RandomState(7)
    n_tri, n_rel = 6 * n_ent, 500
    t1 = torch.as_tensor(bench_triples(rng, n_tri, 0, n_ent, n_rel, 0),
                         device=dev)
    t2 = torch.as_tensor(bench_triples(rng, n_tri, n_ent, 2 * n_ent, n_rel,
                                       n_rel), device=dev)
    cfg = Config(dim=75, batch_size=batch, neg_triple_num=10,
                 row_sparse_updates=True)
    params = init_params(cfg, 2 * n_ent, 2 * n_rel, 2, device=dev)
    opt = streams.init_stream_opt_states(cfg, params)["rel_view"]
    epoch, steps, trained = streams.build_rel_view_epoch(
        cfg, n_tri, n_tri, ((0, n_ent), (n_ent, 2 * n_ent)))
    gen = torch.Generator(device=dev).manual_seed(0)
    loss = float(epoch(params, opt, gen, t1, t2))      # warm-up epoch
    launches0 = ak.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        loss = float(epoch(params, opt, gen, t1, t2))
    dt = time.perf_counter() - t0
    check(np.isfinite(loss), f"throughput epoch loss {loss}")
    per_epoch = (ak.launches - launches0) / epochs
    tps = trained * epochs / dt
    log(f"[rate] rel_view at bench shape ({n_ent} entities, {n_tri} triples "
        f"per KG, batch {batch}, {steps} steps/epoch, K1 launches/epoch "
        f"{per_epoch:g}): {epochs} epochs in {dt:.3f} s -> {tps:,.0f} "
        f"triples/s on {card}")
    busy = profile_epoch(lambda: float(epoch(params, opt, gen, t1, t2)),
                         dt / epochs * 1e3)
    return dict(triples_per_s=tps, seconds_per_epoch=dt / epochs,
                steps_per_epoch=steps, k1_launches_per_epoch=per_epoch,
                **busy)


def profile_epoch(run_epoch, epoch_ms: float, top: int = 8):
    """One epoch under torch.profiler: the device's busy time (union of
    kernel and copy intervals), its share of the profiled epoch's wall time
    and of ``epoch_ms``, the same epoch's time without the profiler (which
    slows the host, not the device), and the kernels that take the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_epoch()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("[prof] the profiler saw no device activity: busy share not "
            "measured")
        return {"device_busy_share": None}
    busy_us, end = 0.0, -1.0
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    share = busy_us / 1e3 / epoch_ms
    log(f"[prof] one epoch: device busy {busy_us / 1e3:.2f} ms = "
        f"{100 * share:.1f}% of the unprofiled epoch ({epoch_ms:.2f} ms), "
        f"{100 * busy_us / wall_us:.1f}% of the profiled one "
        f"({wall_us / 1e3:.2f} ms); {len(spans)} device ops")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    for name, us in ranked:
        log(f"[prof]   {us / 1e3:8.3f} ms  {name[:100]}")
    return {"device_busy_share": share, "device_busy_ms": busy_us / 1e3,
            "profiled_wall_ms": wall_us / 1e3,
            "top_device_ms": {n[:100]: us / 1e3 for n, us in ranked}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--k2-of"):
        print("usage: chip_smoke.py [--k2-of DIR]", file=sys.stderr)
        return 2
    root = os.path.abspath(args[1]) if args else REPO
    if not os.path.isdir(os.path.join(root, "multike_tpu_torch")):
        print(f"chip_smoke: the multike_tpu_torch package is not in {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import multike_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)

    t_start = time.time()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    peaks = card_peaks(card)
    log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"bounds from this part's published peaks: {peaks[0] / 1e12:.2f} "
        f"TB/s, {peaks[1] / 1e12:.0f} TFLOP/s fp32")

    phase_build()
    if args:
        k2 = phase_rank(dev, peaks)
        log(f"[done] K2 of {root} in {time.time() - t_start:.1f} s")
        print(json.dumps({"kernels": [k2]}), flush=True)
        print(card, flush=True)
        return 0
    k1 = phase_apply(dev, peaks)
    k2 = phase_rank(dev, peaks)
    launches = phase_main_path(dev)
    rate = phase_throughput(dev, card)

    k1["launches"] = launches["fused_row_adagrad"]
    k2["launches"] = launches["rank_count"]
    log(f"[rate] {json.dumps(rate)}")
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
