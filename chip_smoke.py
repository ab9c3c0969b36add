#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``multike_tpu_torch``) on one NVIDIA GPU:
what the benchmark (``gpubench/``) cannot show, each kernel against its
plain version and the drivers' and the mesh's paths checked, measured with
the benchmark's own yardsticks (``gpubench/lib``: the cards' peaks, the
kernels' bounds, the inputs).

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-of DIR   # phases 1 and 3 only, for the
                                        # package under DIR (for example an
                                        # earlier commit, from git archive)
    python3 chip_smoke.py --k1-of DIR   # phase 1, then DIR's
                                        # sparse_adagrad.row_apply timed at
                                        # phase 2's steps
    python3 chip_smoke.py --k3          # phases 1 and 2b only
    python3 chip_smoke.py --k4          # phases 1 and 2c only
    python3 chip_smoke.py --k5          # phases 1 and 2d only

(``--mesh-rank TASK SPEC`` is how phase 8 starts its rank processes.) Each
kernel phase says which timer its ``ms`` comes from (``timer``): CUDA
events around back-to-back calls (``events``, wall time) or the sum of a
call's device ops in torch.profiler (``profiler``).

Phases, each of which must pass or the script exits non-zero:

  1. build the host helpers (``csrc/host_helpers.cpp``, with the host C++
     compiler) and the CUDA kernels from ``multike_tpu_torch/csrc``
     (each timed), and report each kernel's registers and spills (a spill
     fails the run);
  2. K1, the whole row-sparse Adagrad apply (``row_adagrad``: dedup and
     update, no sort), at the per-step shape of bench.py (200K x 75 table,
     the ids of one batch-80000 chunk_shared step), at the same ids in a
     200K x 384 table, at the step shape of bench.py's reference-parity
     row (the ids of one batch-5000 per_slot step) and at one per-slot
     rel_view step of phase 7's 20K pair: bitwise equal to its plain
     version on the CPU and from launch to launch, within rtol 2e-6 / atol
     1e-7 of its plain version on the card, no device kernel whose name
     holds "sort" inside a call, timed beside its bytes bound;
  2b. K3, the chunk-shared loss with its gradients, at the relation-view
     cell's step (two KGs: 10 chunks of 4,064 and of 3,937 positives,
     pools of 128, d = 75) and at d = 384, through the wrapper and
     autograd's backward (incoming gradient 0.37), with keep flags and
     without: within rtol 1e-6 (the loss) and 2e-6 of the largest element
     (each gradient) of its plain version in float64 on the card, bitwise
     from call to call and under ``torch.no_grad()``, timed (its two
     kernels apart, by the profiler) beside its FLOP bound and its plain
     version in float32;
  2c. K4, the CNN scorer with its closed-form backward, at the ITC cell's
     CNN step (5,000 rows, d = 75) and at d = 384, through the streams'
     ``conv_score`` and autograd's backward (a mask with a padded tail):
     each output within 2e-5 of its largest element of its plain version
     in float64 on the card, or within twice the error of the plain
     version in float32 and of the eager ``conv_stages`` with autograd
     (cuDNN's convolutions), bitwise from call to call, timed (the device
     time of a call, forward alone and with the backward: its six kernels,
     each also apart, and the fills and copy of its small buffers) beside
     its FLOP bound and the eager ``conv_stages`` with autograd; then
     compared at 4,097 rows and at one row;
  2d. K5, the per-slot loss with its gradients, at the per-slot cell's
     step (two KGs of 2,539 and 2,461 positives, 10 slots each, d = 75, a
     positive mask with a padded tail and keep flags dropping about 1% of
     the slots) and at d = 384, through the wrapper and autograd's
     backward (incoming gradient 0.37): within rtol 1e-6 (the loss) and
     2e-6 of the largest element (each gradient) of its plain version in
     float64 on the card, bitwise from call to call and under
     ``torch.no_grad()``, timed (CUDA events; its two kernels apart, by
     the profiler) beside its bytes bound, its plain version in float32
     and the eager expression the port ran before it, with autograd;
  3. K2, the fused rank count, against its plain version at 35K x 70K,
     d=75, and at the main path's own 6K x 6K and 2K x 8K, then in CSLS
     form; at each shape it is timed beside the plain version and
     ``torch.matmul`` alone, with its bound and launch geometry. Then a
     sweep of the kernel's two plans: at each of those shapes and d = 75,
     128, 256 and 352 both, in turns (resident, streamed, streamed,
     resident) and bitwise equal to each other; at 35K x 70K and d = 353,
     512 and 1024 the streamed plan alone; each the same against the plain
     version (compared, not timed);
  4. the main path: ``MultiKETrainer`` trains the relation view on the
     port's synthetic 20K-entity KG pair and ``views.valid_metrics`` ranks
     it; the rv valid MRR must rise and K1, K2 and K3 must have launched
     (K4 and K5 not);
  5. bench.py's reference-parity row at its shape (100K entities and 600K
     random triples per KG): batch 5000, per_slot negatives with Bloom
     "drop" rejection, uniform and truncated (DWY100K-shaped neighbor
     table), then uniform with "resample" rejection, row-sparse: every
     loss finite, K1 launched and K5 once a KG a step, the drop shares and
     Bloom passes a step reported (phase 2 times K1 at this row's step
     shape);
  6. the ITC driver, through the calls ``cli.main`` makes (DataModel with
     the literal encoder at full width, predicate alignment,
     ``MultiKE_ITC.run``) on the 20K pair, d=75, row-sparse on, cut to 10
     epochs with the neighbor refresh at epoch 5 and one evaluation at
     epoch 10. The host helpers must be the package's own library, built
     under its ``build/``, and give bitwise the plain Python Levenshtein
     matrices of the pair's predicate names and the plain ``.vec`` read.
     Every stream's loss must be finite, K1 must launch in each of
     the 7 streams and K2 once per evaluation, truncated epochs must follow
     the refresh, rv and final valid MRR must rise, the embeddings must be
     saved, and from the trained state one attr_view and one common_space
     step and the neighbor ids of 256 rows must agree with the CPU's;
  7. the SSL driver the same way (phase 6's DataModel, a fresh predicate
     alignment, ``MultiKE_SSL.run``), per-slot draws with Bloom "drop"
     rejection in both phases, 10 epochs (refresh and soft-alignment start
     at 5, one evaluation at 10, WVA included) and 10 epochs of
     space_mapping (one ``final`` valid). Every stream's loss must be
     finite, K1 must launch in all 7 SSL streams, K5 in rel_view alone
     and K2 once per evaluation, per-slot epochs must run before and after the refresh, rv,
     avg and final valid MRR must rise, the 6 test MRRs must be finite and
     the embeddings saved; the Bloom words and membership must be bit-equal
     to the CPU's, and one per-slot rel_view step with its keep mask, one
     space_mapping step and one dense step each of Adam, Adadelta and SGD
     must agree with the CPU's;
  8. the mesh (parallel/*, eval/ring.py), in rank processes of this script
     (``--mesh-rank``), each under a timeout; a failing rank fails the run.
     (a) NCCL at world size 1: a ``MeshContext`` of dp = tp = 1, so the
     gather of (id, row-grad) pairs, the dense all-reduce and the ring's
     gathers go through NCCL; one epoch of each of the 8 streams equals the
     epoch without a mesh (rtol 1e-5 / atol 1e-6 on losses and tables) and
     ``ring_rank_and_align`` equals ``rank_and_align`` exactly, with and
     without CSLS, and K2's plain version up to ties. (b) gloo ranks
     sharing the card: ``spmd.dryrun`` at dp=2 x tp=2 (4 ranks) against
     one rank (rtol 1e-3 per stream); the ring at 35,000 x 70,000, d=75,
     over 2 ranks, with and without CSLS: counts and argmax exactly equal
     to one K2 call on the ring's own gold and penalties, equal up to ties
     to K2's plain version with the one-rank engine's penalties (which the
     ring's must match within 1e-6), and K2 against its plain version on
     the ring's blocks with gold ids outside them; the ITC driver through ``cli.main`` at dp=2 against one
     rank on phase 6's pair and literal cache (per-stream losses of every
     epoch within rtol 2e-3, test MRRs within 0.02). K1 and K2 must launch
     on every rank. The ranks share one card, so their times say nothing
     about scaling.
  9. the ITC driver through ``cli.main`` at ``--set dim=384`` on a
     5K-entity pair, 3 epochs, row-sparse on, one evaluation: K1 to K4
     must launch and K5 not, every stream's loss be finite, the test MRRs reach the
     floors of WIDE_FLOORS and the embeddings be saved; the saved final
     embeddings of the test pairs, ranked once more by K2 and by its
     plain version, must agree up to ties, and give the driver's test MRR.

It then prints one ``{"kernels": [...]}`` line (``launches`` counts the SSL
run; ``launches_by_path`` adds the ITC runs', phase 4's and the mesh
runs' over all ranks, ``mesh_launches_by_rank`` each mesh run's per rank),
the card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": ...}``. Without a CUDA device, or without the
package beside it, it fails.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int) -> float:
    """Wall time of a call of ``fn``, by CUDA events around ``reps``
    back-to-back calls after one more."""
    import torch

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


def device_ms(run, names: str = "", calls: int = 10):
    """Device time of a call of ``run``, from torch.profiler over ``calls``
    calls after one unprofiled call: ``(ms, passes, ops)`` with ``ms`` the
    sum of its kernels', copies' and fills' times, ``passes`` the ms of each
    kernel ``<name>_kernel`` for a name of ``names`` (a regex alternation)
    and ``ops`` the names of every device op that ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    ms, passes, ops = 0.0, {}, set()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = (e.time_range.end - e.time_range.start) / 1e3 / calls
        ms += t
        ops.add(e.name)
        if names and (m := re.search(rf"({names})_kernel", e.name)):
            passes[m[1]] = passes.get(m[1], 0.0) + t
    return ms, passes, ops


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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Build the host helpers, then the kernels, and report each kernel's
    registers and spills from nvcc's ``-Xptxas -v`` log; a kernel that
    spills fails the run. Returns {kernel's mangled name: its numbers}."""
    from multike_tpu_torch.kernels import _build

    t0 = time.time()
    host = _build.build_host()
    _build.load_host()
    secs = time.time() - t0
    log(f"[build] host helpers built and loaded in {secs:.2f} s: "
        f"{os.path.relpath(host, REPO)}")
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
                if (m := re.search(r"(\d+) bytes stack frame", ln)):
                    kernels[name]["stack_bytes"] = int(m[1])
            elif name and (m := re.search(r"Used (\d+) registers", ln)):
                kernels[name]["registers"] = int(m[1])
    check(kernels, "the nvcc log names no kernel")
    for name, info in kernels.items():
        log(f"[build]   {name[:72]}: {info.get('registers')} registers, "
            f"{info.get('spill_bytes')} spill bytes, "
            f"{info.get('stack_bytes')} stack bytes")
        check(info.get("spill_bytes") == 0, f"{name} spills to local memory")
    return kernels


def k1_steps(dev, n_ent=100_000, rel_triples=600_000, ssl_n=20_000,
             seed=0):
    """The ids of phase 2's K1 steps, drawn by the port's rel_view epochs
    (on triples of ``gpubench.lib.data.kg_pair_triples``, bench.py's
    shape): one bench.py step (chunk_shared, batch 80000) into a 200K x 75
    table, the same ids at phase 9's width, one step of bench.py's
    reference-parity row (per_slot, batch 5000), and one per-slot rel_view
    step of the SSL cell (phase 7's 20K synthetic pair, batch 5000).
    Returns [(label, ids, rows, d)]."""
    import torch

    from gpubench.lib import data
    from multike_tpu_torch.config import Config
    from multike_tpu_torch.data.kg import triples_to_array
    from multike_tpu_torch.train import streams

    per_slot = dict(dim=75, batch_size=5000, neg_triple_num=10,
                    neg_scheme="per_slot", truncated_neg_scheme="per_slot")
    bench = (*data.kg_pair_triples(seed, n_ent, (rel_triples, rel_triples),
                                   (500, 500)),
             ((0, n_ent), (n_ent, 2 * n_ent)), 2 * n_ent)
    kgs = synthetic_kgs(ssl_n)
    ssl = (triples_to_array(kgs.kg1.local_relation_triples_set),
           triples_to_array(kgs.kg2.local_relation_triples_set),
           kgs.entity_id_ranges(), kgs.entities_num)

    def step_ids(cfg, tr1, tr2, ranges):
        epoch, _, _ = streams.build_rel_view_epoch(cfg, len(tr1), len(tr2),
                                                   ranges)
        gen = torch.Generator(device=dev).manual_seed(seed)
        t1, t2 = (torch.as_tensor(t, dtype=torch.long, device=dev)
                  for t in (tr1, tr2))
        return epoch._prep(*(x[0] for x in epoch.draw(gen, t1, t2)))[0][
            "rv_ent"]

    chunk = step_ids(Config(dim=75, batch_size=80_000, neg_triple_num=10),
                     *bench[:3])
    return [("chunk_shared", chunk, bench[3], 75),
            ("per_slot", step_ids(Config(**per_slot), *bench[:3]), bench[3],
             75),
            ("wide", chunk, bench[3], WIDE_DIM),
            ("ssl_cell", step_ids(Config(**per_slot), *ssl[:3]), ssl[3], 75)]


def _k1_inputs(dev, ids, rows, d, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    param = torch.randn(rows, d, device=dev, generator=g)
    acc = torch.rand(rows, d, device=dev, generator=g) + 0.1
    g_rows = torch.randn(ids.shape[0], d, device=dev, generator=g)
    return param, acc, g_rows


def phase_apply(dev, peaks, seed=0, **sizes):
    """K1 (``row_adagrad``, the whole row-sparse apply) at each step of
    ``k1_steps``: bitwise equal to its plain version on the CPU, two
    launches bitwise equal, untouched rows untouched, within rtol 2e-6 /
    atol 1e-7 of its plain version on the card (whose dedup sums with
    atomics), no sort kernel inside a call, and its time (CUDA events)
    beside the bound and the plain version's."""
    cases = {label: _k1_case(dev, peaks, ids, rows, d, seed, label)
             for label, ids, rows, d in k1_steps(dev, seed=seed, **sizes)}
    main = cases["chunk_shared"]
    return dict(name="fused_row_adagrad", route="cuda",
                source="multike_tpu_torch/csrc/apply_kernel.cu",
                replaces="multike_tpu/kernels/apply_kernel.py:144",
                wrapper="multike_tpu_torch.kernels.apply_kernel.row_adagrad",
                timer="events",
                max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                cpu_plain_bitwise=all(c["cpu_plain_bitwise"]
                                      for c in cases.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="bytes", library_ms=None,
                shape=main["shape"], per_slot_step=cases["per_slot"],
                wide_step=cases["wide"], ssl_cell_step=cases["ssl_cell"])


def _k1_case(dev, peaks, ids, rows, d, seed, label):
    """K1 on one step's ids into a (rows, d) table."""
    import torch

    from gpubench.lib import bounds
    from multike_tpu_torch.kernels import apply_kernel as ak

    N, lr = ids.shape[0], 0.001
    param, acc, g_rows = _k1_inputs(dev, ids, rows, d, seed)
    counts = torch.bincount(ids, minlength=rows)
    U, most = int((counts > 0).sum()), int(counts.max())
    check(U < N, "the step's ids should hold duplicates")

    runs = []
    for _ in range(2):
        p, a = param.clone(), acc.clone()
        ak.row_adagrad(p, a, ids, g_rows, lr)
        runs.append((p, a))
    p_p, a_p = param.clone(), acc.clone()
    ak.row_adagrad_plain(p_p, a_p, ids, g_rows, lr)
    torch.cuda.synchronize()
    p_c, a_c = (t.to("cpu", copy=True) for t in (param, acc))
    ak.row_adagrad_plain(p_c, a_c, ids.cpu(), g_rows.cpu(), lr)
    (p_k, a_k), (p_2, a_2) = runs
    repeat = torch.equal(p_k, p_2) and torch.equal(a_k, a_2)
    bitwise = torch.equal(p_k.cpu(), p_c) and torch.equal(a_k.cpu(), a_c)
    check(repeat, f"K1 {label}: two launches differ")
    check(bitwise, f"K1 {label}: not bitwise equal to the CPU plain version")
    err = max(float((p_k - p_p).abs().max()), float((a_k - a_p).abs().max()))
    for got, want, name in ((p_k, p_p, "param"), (a_k, a_p, "acc")):
        bad = (got - want).abs() > 1e-7 + 2e-6 * want.abs()
        check(not bool(bad.any()), f"K1 {name}: {int(bad.sum())} elements "
              "outside rtol 2e-6 / atol 1e-7 of the card's plain version")
    touched = counts > 0
    check(torch.equal(p_k[~touched], param[~touched]) and
          torch.equal(a_k[~touched], acc[~touched]),
          "K1 changed rows the step does not touch")
    check(bool((a_k[touched] != acc[touched]).any(dim=1).all()),
          "K1 left a touched row's accumulator unchanged")
    del runs, p_2, a_2, p_c, a_c

    ms = time_ms(lambda: ak.row_adagrad(p_k, a_k, ids, g_rows, lr), 20)
    plain_ms = time_ms(
        lambda: ak.row_adagrad_plain(p_p, a_p, ids, g_rows, lr), 5)
    _, passes, ops = device_ms(
        lambda: ak.row_adagrad(p_k, a_k, ids, g_rows, lr),
        "count|place|fill|apply")
    sorts = sorted(o for o in ops if "sort" in o.lower())
    check(not sorts, f"K1 {label}: a row_adagrad call ran sort kernels "
          f"{sorts}")
    mem_rate = peaks[0]
    bound_ms = bounds.k1_bytes(N, U, d) / mem_rate * 1e3
    log(f"[K1] {label} step, rows={rows} d={d} ids={N} unique={U} (most "
        f"{most} a row): kernel {ms:.4f} ms (CUDA events), bound "
        f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%; N(8 + 4d) + 16Ud "
        f"bytes at {mem_rate / 1e12:.2f} TB/s), plain {plain_ms:.4f} ms; "
        f"bitwise equal to the CPU plain version and run to run; {err:.3e} "
        "from the card's plain version; no sort kernel; passes (profiler "
        "ms) " + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
    return dict(max_abs_err=err, cpu_plain_bitwise=bitwise,
                repeat_bitwise=repeat, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_share=bound_ms / ms,
                passes_ms=passes,
                shape=dict(rows=rows, d=d, ids=N, unique=U, most=most))


# K3's shapes: a step of the benchmark's relation-view cell
# rv-dwy100k-chunk-b80k (batch 80,000 of 463,294 and 448,774 triples: 10
# chunks of 4,064 and of 3,937 positives, pools of 128, d = 75), and the
# first KG's chunks at d = 384
K3_STEP = ((10, 4064, 128, 75), (10, 3937, 128, 75))
K3_WIDE = ((10, 4064, 128, 384),)


def k3_inputs(dev, nc, s, c, d, seed, keep=False):
    """Unit rows of one KG's chunks and pools, a chunk-padding mask (a
    masked tail in the last chunk, as the epoch pads) and, with ``keep``,
    keep flags dropping about 1% of the pairs (as exact rejection does);
    without, none, as the cell's uniform phase has it."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    rows = [torch.nn.functional.normalize(
        torch.randn(nc, n, d, device=dev, generator=g), dim=-1)
        for n in (s, s, s, c, c)]
    mask = torch.ones(nc, s, device=dev)
    mask[-1, s - 7:] = 0.0
    flags = [None, None]
    if keep:
        flags = [(torch.rand(nc, s, c, device=dev, generator=g) > 0.01)
                 .float() for _ in range(2)]
    return rows, mask, flags


def _k3_grads(rows, w, mask, flags, gout):
    """The loss and the five gradients as the main path takes them: the
    wrapper's ``Function`` on leaves, then autograd's backward with the
    incoming gradient ``gout`` (a 0-dim tensor on the rows' device)."""
    import torch

    from multike_tpu_torch.kernels import chunk_loss as ck

    leaves = [x.detach().requires_grad_() for x in rows]
    loss = ck.chunk_shared_loss(*leaves, w, mask, *flags)
    grads = torch.autograd.grad(loss, leaves, gout)
    return loss.detach(), grads


def _k3_case(dev, peaks, kgs, label, seed=0, w=10 / 256, scale=0.37):
    """K3 over the KGs ``kgs`` of one step, (nc, s, c, d) each, through
    the wrapper the main path calls (``chunk_shared_loss`` and autograd's
    backward with an incoming gradient of ``scale``), with keep flags and
    without: against its plain version in float64 on the card (the loss
    within rtol 1e-6, each gradient within 2e-6 of its largest element),
    bitwise from call to call and under ``torch.no_grad()``; the launcher
    timed (CUDA events; its two kernels apart, by the profiler) beside its
    bound and the plain version in float32."""
    import torch

    from multike_tpu_torch.kernels import chunk_loss as ck

    err = 0.0
    gout = torch.tensor(scale, device=dev)
    for keep in (False, True):
        ins = [k3_inputs(dev, *kg, seed + i, keep) for i, kg in
               enumerate(kgs)]
        for rows, mask, flags in ins:
            n = ck.launches
            loss, grads = _k3_grads(rows, w, mask, flags, gout)
            loss2, grads2 = _k3_grads(rows, w, mask, flags, gout)
            with torch.no_grad():
                alone = ck.chunk_shared_loss(*rows, w, mask, *flags)
            torch.cuda.synchronize()
            check(ck.launches == n + 3, f"K3 {label}: {ck.launches - n} "
                  "launches for three calls")
            check(torch.equal(loss, loss2) and all(
                torch.equal(a, b) for a, b in zip(grads, grads2)),
                f"K3 {label}: two calls differ")
            check(torch.equal(alone, loss), f"K3 {label}: the loss under "
                  "no_grad differs from the loss with its gradients")
            want_loss, want = ck.chunk_shared_loss_plain(
                *(x.double() for x in rows), neg_weight=w,
                pos_mask=mask.double(),
                **{k: None if f is None else f.double()
                   for k, f in zip(("keep_h", "keep_t"), flags)})
            rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
            check(rel <= 1e-6, f"K3 {label}: loss {float(loss)} is "
                  f"{rel:.2e} from the float64 plain version's "
                  f"{float(want_loss)}")
            for name, got, g in zip(("phs", "prs", "pts", "cand_h",
                                     "cand_t"), grads, want):
                g = scale * g
                check(got.shape == g.shape, f"K3 {label}: {name}'s "
                      f"gradient {tuple(got.shape)}, not {tuple(g.shape)}")
                e = float((got.double() - g).abs().max()) / float(
                    g.abs().max())
                check(e <= 2e-6, f"K3 {label}: {name}'s gradient {e:.2e} "
                      "of its largest element from the float64 plain "
                      "version")
                err = max(err, e)

    ins = [k3_inputs(dev, *kg, seed + i) for i, kg in enumerate(kgs)]

    def step(fn):
        return [fn(*rows, w, mask, *flags) for rows, mask, flags in ins]

    def wrapped():
        return [_k3_grads(rows, w, mask, flags, gout)
                for rows, mask, flags in ins]

    pairs = sum(nc * s * 2 * c for nc, s, c, _ in kgs)
    flops = sum(nc * s * 2 * c * 6 * d for nc, s, c, d in kgs)
    bound_ms = flops / peaks[1] * 1e3
    ms = time_ms(lambda: step(ck._launch), 20)
    wrapper_ms = time_ms(wrapped, 20)
    plain_ms = time_ms(lambda: step(ck.chunk_shared_loss_plain), 5)
    passes = device_ms(lambda: step(ck._launch), "chunk_loss|pool_sum")[1]
    log(f"[K3] {label}: {kgs}, {pairs} pairs: kernel {ms:.4f} ms a step "
        f"(CUDA events; profiler passes "
        f"{', '.join(f'{k} {v:.4f}' for k, v in passes.items())}; "
        f"through the wrapper and autograd {wrapper_ms:.4f}), bound "
        f"{bound_ms:.4f} ms "
        f"({100 * bound_ms / ms:.1f}%; 6d FLOPs a pair at "
        f"{peaks[1] / 1e12:.0f} TFLOP/s), plain {plain_ms:.4f} ms; bitwise "
        f"call to call; the wrapper's gradients {err:.2e} of their largest "
        "element from the float64 plain version")
    return dict(ms=ms, wrapper_ms=wrapper_ms, passes_ms=passes,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_share=bound_ms / ms, max_rel_err=err, pairs=pairs,
                flops=flops, shape=[list(kg) for kg in kgs])


def phase_chunk_loss(dev, peaks):
    """K3 at the relation-view cell's step and at d = 384."""
    main = _k3_case(dev, peaks, K3_STEP, "rel_view cell step")
    wide = _k3_case(dev, peaks, K3_WIDE, "d = 384")
    return dict(name="chunk_loss", route="cuda",
                source="multike_tpu_torch/csrc/chunk_loss_kernel.cu",
                replaces=None,
                wrapper="multike_tpu_torch.kernels.chunk_loss."
                        "chunk_shared_loss", timer="events",
                max_rel_err=max(main["max_rel_err"], wide["max_rel_err"]),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="operations",
                library_ms=None, shape=main["shape"], step=main,
                wide_step=wide)


# K5's shapes: a step of the benchmark's per-slot cell
# rv-dwy100k-perslot-trunc (batch 5,000 of 463,294 and 448,774 triples:
# 2,539 and 2,461 positives, 10 slots each, d = 75), and the same step at
# d = 384
K5_STEP = ((2539, 10, 75), (2461, 10, 75))
K5_WIDE = ((2539, 10, 384), (2461, 10, 384))


def k5_bytes(b, k, d) -> int:
    """The least bytes a call of K5 moves: every row (h, r, t and the K
    candidates) read once and its gradient written once, in fp32, with the
    coins (one byte a slot), the keep flags and the mask (fp32) read once
    and the loss written once."""
    return 2 * 4 * (3 + k) * b * d + (1 + 4) * b * k + 4 * b + 4


def k5_inputs(dev, b, k, d, masks, seed, coins="mixed"):
    """Unit rows of one KG's positives and candidates, made with numpy from
    ``seed``, and the coins (``coins`` "mixed", "head" or "tail"). With
    ``masks`` true, a positive mask with a padded tail of 7 rows and keep
    flags dropping about 1% of the slots (the cell's Bloom drop takes
    0.58%); with ``masks`` "all", a mask of zeros and such keep flags.
    Tensors on ``dev``: ``(xs, head, kw)``, ``kw`` the masks by their
    keyword names (empty without masks)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)

    def rows(*shape):
        x = rng.randn(*shape, d).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    to = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    xs = [to(x) for x in (rows(b), rows(b), rows(b), rows(b, k))]
    head = {"mixed": rng.rand(b, k) > 0.5, "head": np.ones((b, k), bool),
            "tail": np.zeros((b, k), bool)}[coins]
    kw = {}
    if masks:
        m = (np.arange(b) < max(b - 7, 1)).astype(np.float32)
        kw = dict(pos_mask=to(m if masks is True else 0 * m),
                  neg_keep=to((rng.rand(b, k) > 0.01).astype(np.float32)))
    return xs, to(head), kw


def eager_lean_loss(phs, prs, pts, cand_rows, corrupt_head, pos_mask=None,
                    neg_keep=None):
    """The per-slot loss as the port ran it before K5: eager ops, the
    negative distances expanded into einsums, differentiated by autograd
    (the yardstick of K5's time, and of its plain version's gradients in
    the CPU tests)."""
    import torch
    import torch.nn.functional as F

    def sq(x):
        return torch.sum(torch.square(x), dim=-1)

    pos = F.softplus(sq(phs + prs - pts))
    rt, hr = prs - pts, phs + prs
    c_sq = sq(cand_rows)
    ns_h = -(c_sq + sq(rt)[:, None]
             + 2.0 * torch.einsum("bkd,bd->bk", cand_rows, rt))
    ns_t = -(sq(hr)[:, None] + c_sq
             - 2.0 * torch.einsum("bkd,bd->bk", cand_rows, hr))
    neg = F.softplus(torch.where(corrupt_head, ns_h, ns_t))
    if neg_keep is not None:
        neg = neg * neg_keep
    if pos_mask is not None:
        pos = pos * pos_mask
        neg = neg * pos_mask[:, None]
    return torch.sum(pos) + torch.sum(neg)


def k5_grads(xs, head, kw, scale, loss_fn=None):
    """The loss and the four gradients as the main path takes them: the
    wrapper's autograd ``Function`` (or ``loss_fn``) on leaves, then
    autograd's backward with the incoming gradient ``scale``."""
    import torch

    from multike_tpu_torch.kernels import per_slot_loss as k5

    leaves = [x.detach().requires_grad_() for x in xs]
    loss = (loss_fn or k5.per_slot_loss)(*leaves, head, **kw)
    grads = torch.autograd.grad(loss, leaves,
                                torch.tensor(scale, device=loss.device))
    return loss.detach(), grads


# K5 against its plain version in float64: the loss within this share of
# its value, each gradient within this share of its largest element. K5 is
# float32: each distance is rounded once (about 6e-8 of a distance up to 9)
# and a row's gradient sums at most K + 1 terms.
K5_LOSS_RTOL = 1e-6
K5_GRAD_TOL = 2e-6


def k5_errors(xs, head, kw, scale, loss, grads):
    """``(loss_err, grad_err)`` of a K5 result (gradients scaled by the
    incoming ``scale``) against the plain version in float64: the loss's
    gap over its value (the gap itself where the value is 0, as an
    all-masked batch's is) and the largest gap of a gradient over that
    gradient's largest element (its largest element where the plain one
    is all 0). A gradient of another shape raises."""
    from multike_tpu_torch.kernels import per_slot_loss as k5

    want_loss, want = k5.per_slot_loss_plain(
        *(x.double() for x in xs), head,
        **{n: v.double() for n, v in kw.items()})
    gap = abs(float(loss) - float(want_loss))
    loss_err = gap / abs(float(want_loss)) if float(want_loss) else gap
    grad_err = 0.0
    for name, x, got, g in zip(("phs", "prs", "pts", "cand_rows"), xs, grads,
                               want):
        check(got.shape == x.shape, f"K5: {name}'s gradient "
              f"{tuple(got.shape)}, not {tuple(x.shape)}")
        g = scale * g
        top = float(g.abs().max())
        e = float((got.double() - g).abs().max())
        grad_err = max(grad_err, e / top if top else e)
    return loss_err, grad_err


def _k5_case(dev, peaks, kgs, label, seed=0, scale=0.37):
    """K5 over the KGs ``kgs`` of one step, (b, k, d) each, with the cell's
    masks, through the wrapper the main path calls and autograd's backward
    with an incoming gradient of ``scale``: against its plain version in
    float64 on the card (``k5_errors`` within ``K5_LOSS_RTOL`` and
    ``K5_GRAD_TOL``), bitwise from call to call and under
    ``torch.no_grad()``; the launcher timed (CUDA events; its two kernels
    apart, by the profiler) beside its bytes bound, the plain version in
    float32 and the eager expression with autograd."""
    import torch

    from multike_tpu_torch.kernels import per_slot_loss as k5

    err = 0.0
    ins = [k5_inputs(dev, *kg, True, seed + i) for i, kg in enumerate(kgs)]
    for xs, head, kw in ins:
        n = k5.launches
        loss, grads = k5_grads(xs, head, kw, scale)
        loss2, grads2 = k5_grads(xs, head, kw, scale)
        with torch.no_grad():
            alone = k5.per_slot_loss(*xs, head, **kw)
        torch.cuda.synchronize()
        check(k5.launches == n + 3, f"K5 {label}: {k5.launches - n} "
              "launches for three calls")
        check(torch.equal(loss, loss2) and all(
            torch.equal(a, b) for a, b in zip(grads, grads2)),
            f"K5 {label}: two calls differ")
        check(torch.equal(alone, loss), f"K5 {label}: the loss under "
              "no_grad differs from the loss with its gradients")
        loss_err, grad_err = k5_errors(xs, head, kw, scale, loss, grads)
        check(loss_err <= K5_LOSS_RTOL, f"K5 {label}: loss {float(loss)} "
              f"is {loss_err:.2e} from the float64 plain version's")
        check(grad_err <= K5_GRAD_TOL, f"K5 {label}: a gradient "
              f"{grad_err:.2e} of its largest element from the float64 "
              "plain version")
        err = max(err, grad_err)

    def step(fn):
        return [fn(*xs, head, kw["pos_mask"], kw["neg_keep"])
                for xs, head, kw in ins]

    def wrapped(loss_fn=None):
        return [k5_grads(xs, head, kw, scale, loss_fn)
                for xs, head, kw in ins]

    slots = sum(b * k for b, k, _ in kgs)
    nbytes = sum(k5_bytes(*kg) for kg in kgs)
    bound_ms = nbytes / peaks[0] * 1e3
    ms = time_ms(lambda: step(k5._launch), 50)
    wrapper_ms = time_ms(wrapped, 50)
    plain_ms = time_ms(lambda: step(k5.per_slot_loss_plain), 10)
    eager_ms = time_ms(lambda: wrapped(eager_lean_loss), 10)
    eager_card_ms = device_ms(lambda: wrapped(eager_lean_loss))[0]
    card_ms, passes, _ = device_ms(lambda: step(k5._launch),
                                   "per_slot_loss|slot_loss_sum")
    log(f"[K5] {label}: {kgs}, {slots} slots: kernel {ms:.4f} ms a step "
        f"(CUDA events; profiler {card_ms:.4f}, passes "
        f"{', '.join(f'{k} {v:.4f}' for k, v in passes.items())}; "
        f"through the wrapper and autograd {wrapper_ms:.4f}), bound "
        f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%; {nbytes} bytes at "
        f"{peaks[0] / 1e12:.2f} TB/s), plain fp32 {plain_ms:.4f} ms, eager "
        f"with autograd {eager_ms:.4f} ms ({eager_card_ms:.4f} of card); "
        f"bitwise call to call; the wrapper's gradients {err:.2e} of their "
        "largest element from the float64 plain version")
    return dict(ms=ms, card_ms=card_ms, wrapper_ms=wrapper_ms,
                passes_ms=passes, plain_ms=plain_ms, eager_ms=eager_ms,
                eager_card_ms=eager_card_ms, bound_ms=bound_ms,
                bound_share=bound_ms / ms, max_rel_err=err, slots=slots,
                bytes=nbytes, shape=[list(kg) for kg in kgs])


def phase_slot_loss(dev, peaks, built=None):
    """K5 at the per-slot cell's step and at d = 384; ``built`` (phase 1's
    report) gives its registers and spills."""
    main = _k5_case(dev, peaks, K5_STEP, "per-slot cell step")
    wide = _k5_case(dev, peaks, K5_WIDE, "d = 384")
    regs = {name: info for name, info in (built or {}).items()
            if "per_slot_loss" in name or "slot_loss_sum" in name}
    return dict(name="per_slot_loss", route="cuda",
                source="multike_tpu_torch/csrc/per_slot_loss_kernel.cu",
                replaces=None,
                wrapper="multike_tpu_torch.kernels.per_slot_loss."
                        "per_slot_loss", timer="events",
                max_rel_err=max(main["max_rel_err"], wide["max_rel_err"]),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="bytes",
                library_ms=None, eager_ms=main["eager_ms"],
                registers=regs, shape=main["shape"], step=main,
                wide_step=wide)

# K4's shapes: a CNN step of the ITC cell itc-dwy100k (attribute_batch_size
# 5,000 rows, d = 75) and the same rows at phase 9's width
K4_STEPS = ((5000, 75), (5000, 384))
K4_PASSES = "conv_rows|conv_out|conv_t|conv_bwd_rows|conv_wgrad|conv_sum"


def k4_inputs(dev, B, d, seed):
    """A scorer with a non-trivial batch norm and biases, unit head and
    value rows, attribute rows at the attribute table's scale, a mask with
    a padded tail of 7 rows and an incoming gradient of the scores."""
    import torch

    from multike_tpu_torch import params as tp

    g = torch.Generator(device=dev).manual_seed(seed)
    p = {k: x.to(dev) for k, x in tp.init_conv_params(
        torch.Generator().manual_seed(seed), d, "cpu").items()}
    p["bn_gamma"] = 1 + 0.3 * torch.randn(d, device=dev, generator=g)
    for k in ("bn_beta", "conv0_b", "conv1_b", "dense_b"):
        p[k] = 0.1 * torch.randn(p[k].shape, device=dev, generator=g)
    unit = lambda x: torch.nn.functional.normalize(x, dim=-1)  # noqa: E731
    h = unit(torch.randn(B, d, device=dev, generator=g))
    a = 0.1 * torch.randn(B, d, device=dev, generator=g)
    v = unit(torch.randn(B, d, device=dev, generator=g))
    mask = torch.ones(B, device=dev)
    mask[max(B - 7, 1):] = 0.0
    gs = torch.rand(B, device=dev, generator=g) - 0.5
    return p, (h, a, v), mask, gs


def _k4_grads(p, rows, mask, gs, score_fn=None):
    """The scores and their gradients with respect to the rows and every
    parameter for the incoming gradient ``gs``, through ``score_fn``
    (default: the streams' ``conv_score``, K4 on the card) and autograd."""
    import torch

    from multike_tpu_torch.views import attr_conv

    score_fn = score_fn or attr_conv.conv_score
    names = list(p)
    leaves = [x.detach().requires_grad_() for x in (*rows, *p.values())]
    score = score_fn(dict(zip(names, leaves[3:])), *leaves[:3], mask=mask)
    grads = torch.autograd.grad(score, leaves, gs)
    return score.detach(), dict(zip(["h", "a", "v", *names], grads))


def _k4_plain64(p, rows, mask, gs):
    """The scores and gradients of the plain version in float64."""
    from multike_tpu_torch.kernels import conv_score as k4

    want_s, back = k4.conv_score_plain({k: x.double() for k, x in p.items()},
                                       *(x.double() for x in rows),
                                       mask.double())
    return want_s, back(gs.double())


def _k4_errors(got_score, got, want_score, want):
    """Each output's largest error over its largest element."""
    out = {"score": float((got_score.double() - want_score).abs().max())
           / float(want_score.abs().max())}
    for k, w in want.items():
        top = float(w.abs().max())
        e = float((got[k].double() - w).abs().max())
        out[k] = e / top if top > 0 else e
    return out


def _k4_case(dev, peaks, B, d, seed=0):
    """K4 at (B, d) through the streams' ``conv_score`` and autograd's
    backward: against the plain version in float64 on the card (each
    output within 2e-5 of its largest element, or within twice the error
    of the plain version in float32 and of the eager ``conv_stages`` with
    autograd, cuDNN's convolutions, on the card), bitwise from call to
    call, one forward launch a call; timed (the device time of a call,
    forward alone and with the backward, and of each of its six kernels)
    beside the bound and the eager ``conv_stages`` with autograd
    (``plain``)."""
    import torch

    from gpubench.lib import bounds, bounds_itc
    from multike_tpu_torch.kernels import conv_score as k4
    from multike_tpu_torch.views import attr_conv

    p, rows, mask, gs = k4_inputs(dev, B, d, seed)
    n = k4.launches
    s1, g1 = _k4_grads(p, rows, mask, gs)
    s2, g2 = _k4_grads(p, rows, mask, gs)
    torch.cuda.synchronize()
    check(k4.launches == n + 2, f"K4 ({B}, {d}): {k4.launches - n} forward "
          "launches for two calls")
    check(torch.equal(s1, s2) and all(torch.equal(g1[k], g2[k]) for k in g1),
          f"K4 ({B}, {d}): two calls differ")
    want_s, want = _k4_plain64(p, rows, mask, gs)
    err = _k4_errors(s1, g1, want_s, want)
    s32, back32 = k4.conv_score_plain(p, *rows, mask)
    plain32 = _k4_errors(s32, back32(gs), want_s, want)

    def stages(pp, h, a, v, mask=None):
        return attr_conv.conv_stages(pp, h, a, v, mask=mask)["score"]

    eager = _k4_errors(*_k4_grads(p, rows, mask, gs, stages), want_s, want)
    for k, e in err.items():
        check(e <= max(2e-5, 2 * plain32[k], 2 * eager[k]),
              f"K4 ({B}, {d}): {k} {e:.2e} of its largest element from the "
              f"float64 plain version (float32 plain {plain32[k]:.2e}, eager "
              f"{eager[k]:.2e})")

    def fwd():
        return k4._launch_forward(p, *rows, mask, None)

    def fwd_bwd():
        return fwd()[1](gs)

    flops = B * bounds_itc.conv_row_flops(d) * (1 + bounds.BACKWARD)
    bound_ms = flops / peaks[1] * 1e3
    fwd_dev = device_ms(fwd)[0]
    ms, passes, _ = device_ms(fwd_bwd, K4_PASSES)
    wall_ms = time_ms(fwd_bwd, 20)
    wrapper_ms = time_ms(lambda: _k4_grads(p, rows, mask, gs), 20)
    plain_ms = device_ms(lambda: _k4_grads(p, rows, mask, gs, stages))[0]
    plain_wall_ms = time_ms(lambda: _k4_grads(p, rows, mask, gs, stages), 20)
    closed_ms = device_ms(
        lambda: k4.conv_score_plain(p, *rows, mask)[1](gs))[0]
    worst = max(err.values())
    log(f"[K4] ({B}, {d}): card {ms:.4f} ms (profiler) forward and backward "
        f"(forward {fwd_dev:.4f}; passes "
        f"{', '.join(f'{k} {v:.4f}' for k, v in passes.items())}; wall "
        f"{wall_ms:.4f}, through conv_score and autograd {wrapper_ms:.4f}), "
        f"bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%; "
        f"conv_row_flops x {1 + bounds.BACKWARD} at {peaks[1] / 1e12:.0f} "
        f"TFLOP/s), plain (eager conv_stages and autograd, cuDNN) "
        f"{plain_ms:.4f} ms card, {plain_wall_ms:.4f} wall; closed form "
        f"fp32 {closed_ms:.4f} card; worst error {worst:.2e} (float32 plain "
        f"{max(plain32.values()):.2e}, eager {max(eager.values()):.2e}); "
        "bitwise call to call")
    return dict(ms=ms, forward_ms=fwd_dev, passes_ms=passes, wall_ms=wall_ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                plain_wall_ms=plain_wall_ms, closed_form_ms=closed_ms,
                bound_ms=bound_ms, bound_share=bound_ms / ms, flops=flops,
                max_rel_err=worst, errors=err, plain32_errors=plain32,
                eager_errors=eager, shape=[B, d])


def phase_conv_score(dev, peaks):
    """K4 at the ITC cell's CNN step and at d = 384, then at 4,097 and one
    row (compared, not timed)."""
    import torch

    main, wide = (_k4_case(dev, peaks, B, d) for B, d in K4_STEPS)
    for B, d in ((4097, 75), (1, 75)):
        p, rows, mask, gs = k4_inputs(dev, B, d, 1)
        err = _k4_errors(*_k4_grads(p, rows, mask, gs),
                         *_k4_plain64(p, rows, mask, gs))
        torch.cuda.synchronize()
        check(max(err.values()) <= 2e-5, f"K4 ({B}, {d}): {err}")
        log(f"[K4] ({B}, {d}): worst error {max(err.values()):.2e}")
    return dict(name="conv_score", route="cuda",
                source="multike_tpu_torch/csrc/conv_score_kernel.cu",
                replaces=None,
                wrapper="multike_tpu_torch.views.attr_conv.conv_score",
                timer="profiler",
                max_rel_err=max(main["max_rel_err"], wide["max_rel_err"]),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="operations",
                library_ms=None, shape=main["shape"], step=main,
                wide_step=wide)


def phase_k1_of(dev, peaks, root, seed=0, **sizes):
    """``sparse_adagrad.row_apply`` of the package under ``root`` at each
    step of ``k1_steps``, timed as phase 2 times K1 (CUDA events)."""
    from gpubench.lib import bounds
    from multike_tpu_torch.train import sparse_adagrad

    out = {}
    for label, ids, rows, d in k1_steps(dev, seed=seed, **sizes):
        param, acc, g_rows = _k1_inputs(dev, ids, rows, d, seed)
        U = int(ids.unique().numel())
        rec = dict(rows=rows, d=d, ids=ids.shape[0], unique=U,
                   bound_ms=bounds.k1_bytes(ids.shape[0], U, d) / peaks[0]
                   * 1e3)
        rec["row_apply_ms"] = time_ms(lambda: sparse_adagrad.row_apply(
            param, acc, ids, g_rows, 0.001), 20)
        log(f"[K1-of] {label} step: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()))
        out[label] = rec
    return out


def _rank_inputs(dev, n1, n2, d, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    e1 = torch.randn(n1, d, device=dev, generator=g)
    e2 = torch.randn(n2, d, device=dev, generator=g)
    e2[:n1] += 0.5 * e1                     # aligned pairs, nonzero ranks
    e1 = e1 / e1.norm(dim=1, keepdim=True)
    e2 = e2 / e2.norm(dim=1, keepdim=True)
    return e1.contiguous(), e2.contiguous()


def _rank_compare(e1, e2, gold, r2, got, want, gidx=None):
    """(count mismatches, argmax mismatches, rows near a tie). A mismatch is
    allowed only on a row where a competing score lies within 1e-6 of its
    gold (count) or of its best score (argmax). Row i's gold column is
    ``gidx[i]`` (default i); one outside ``[0, len(e2))`` is no column."""
    import torch

    c_bad = torch.nonzero(got[0] != want[0]).flatten()
    i_bad = torch.nonzero(got[1] != want[1]).flatten()
    rows = torch.unique(torch.cat([c_bad, i_bad]))
    for i in rows.tolist():
        s = e1[i] @ e2.T
        if r2 is not None:
            s = 2 * s - r2
        near_best = int(((s - s.max()).abs() <= 1e-6).sum()) > 1
        g = i if gidx is None else int(gidx[i])
        if 0 <= g < len(s):
            s[g] = float("inf")             # the gold column is not counted
        near_gold = bool(((s - gold[i]).abs() <= 1e-6).any())
        check(near_gold or near_best,
              f"K2 row {i}: count {int(got[0][i])} vs {int(want[0][i])}, "
              f"argmax {int(got[1][i])} vs {int(want[1][i])} with no tie")
    return int(c_bad.numel()), int(i_bad.numel()), int(rows.numel())


# K2's shapes: DWY100K's test size, then the 20K main path's own test and
# validation (data/synthetic.py's 6/1/3 split of 20,000 links: 6,000 x 6,000
# and 2,000 x (2,000 + 6,000)), each with its timing repetitions.
RANK_SHAPES = ((35_000, 70_000, 5), (6_000, 6_000, 20), (2_000, 8_000, 20))


def _rank_twice(rk, *args, **kw):
    """Two kernel calls, which must return bitwise-equal outputs."""
    import torch

    first = rk.rank_count(*args, **kw)
    second = rk.rank_count(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(first, second)),
          "K2 returned different outputs for the same inputs")
    return first


def _rank_shape(dev, peaks, n1, n2, d, reps, seed, clock_calls=0,
                time_plain=True, path=None, outputs=False):
    """K2 at one shape: tie-only mismatches against the plain version,
    bitwise-equal repeats, and the times of the kernel, the plain version
    (unless not ``time_plain``) and ``torch.matmul`` alone beside the
    bound. ``path`` forces the kernel's plan; ``outputs`` keeps the
    kernel's outputs under "outputs". With ``clock_calls``, the SM clock
    under a sustained run of the kernel, and the share of the FFMA issue
    slots at that clock that the kernel's products fill."""
    import torch

    from gpubench.lib import bounds
    from multike_tpu_torch.kernels import rank_kernel as rk

    kw = {} if path is None else {"_path": path}
    e1, e2 = _rank_inputs(dev, n1, n2, d, seed)
    gold = (e1 * e2[:n1]).sum(1)
    gidx = torch.arange(n1, dtype=torch.int32, device=dev)
    got = _rank_twice(rk, e1, gold, gidx, e2, **kw)
    want = rk.rank_count_plain(e1, gold, gidx, e2)
    torch.cuda.synchronize()
    c_mis, i_mis, ties = _rank_compare(e1, e2, gold, None, got, want)
    err = float((got[2] - want[2]).abs().max())

    ms = time_ms(lambda: rk.rank_count(e1, gold, gidx, e2, **kw), reps)
    plain_ms = time_ms(lambda: rk.rank_count_plain(e1, gold, gidx, e2),
                       max(3, reps // 4)) if time_plain else None
    library_ms = time_ms(lambda: torch.matmul(e1, e2.T), max(3, reps // 2))
    flops = bounds.k2_ops(n1, n2, d)
    nbytes = (n1 + n2) * d * 4 + n1 * 8 + n1 * 12
    mem_rate, fp32_rate = peaks
    bound_ms = max(flops / fp32_rate, nbytes / mem_rate) * 1e3
    geo = rk.plan(n1, n2, d, device=dev, **kw)
    if clock_calls:
        clk = clocks_under_load(lambda: rk.rank_count(e1, gold, gidx, e2),
                                clock_calls)
        clk["ffma_slot_share"] = (flops / ms / 1e9) / (
            fp32_rate / 1e12 * clk["sm_mhz"] / clk["max_sm_mhz"])
        geo["clock"] = clk
    log(f"[K2] {n1}x{n2} d={d}: kernel {ms:.4f} ms = "
        f"{flops / ms / 1e9:.2f} TFLOP/s = {100 * bound_ms / ms:.1f}% of the "
        f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP at "
        f"{fp32_rate / 1e12:.0f} TFLOP/s fp32); "
        + (f"plain {plain_ms:.4f} ms; " if time_plain else "")
        + f"torch.matmul alone {library_ms:.4f} ms")
    log(f"[K2]   {geo['tiles']} tiles of 128x128 on {geo['ctas']} CTAs "
        f"({geo['resident']} resident slots, {geo['ctas_per_sm']} per SM, "
        f"{geo['waves']} wave, {geo['tiles_per_cta_min']}-"
        f"{geo['tiles_per_cta_max']} tiles per CTA, {geo['smem']} B shared "
        f"memory each); {geo['path']} plan")
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
    rec = dict(n1=n1, n2=n2, d=d, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms,
               bound_share=bound_ms / ms, tflops=flops / ms / 1e9,
               max_abs_err=err, count_mismatches=c_mis,
               argmax_mismatches=i_mis, tie_rows=ties, **geo)
    if outputs:
        rec["outputs"] = got
    return rec


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
                timer="events",
                max_abs_err=max([cerr] + [x["max_abs_err"] for x in shapes]),
                ms=big["ms"], plain_ms=big["plain_ms"],
                bound_ms=big["bound_ms"], bound_by="operations",
                library_ms=big["library_ms"],
                count_mismatches=cc + sum(x["count_mismatches"] for x in shapes),
                argmax_mismatches=ci + sum(x["argmax_mismatches"]
                                           for x in shapes),
                tie_rows=ct + sum(x["tie_rows"] for x in shapes),
                shape=dict(n1=big["n1"], n2=big["n2"], d=d), shapes=shapes)


# K2's plan sweep: both plans at phase 3's shapes where both fit (the
# crossover in rank_kernel.cu is set from these, and d = 75 shows whether
# the resident plan earns its place), then the streamed plan past the 352
# that the resident plan holds.
BOTH_PLANS = ("resident", "streamed")
WIDTHS = tuple((shape, d, BOTH_PLANS) for shape in RANK_SHAPES
               for d in (75, 128, 256, 352)) + tuple(
    (RANK_SHAPES[0], d, ("streamed",)) for d in (353, 512, 1024))


def phase_widths(dev, peaks, widths=WIDTHS):
    """K2 at each (shape, width, plans) of ``widths`` as ``_rank_shape``
    runs it, with the plain version compared and not timed; two plans run
    in turns (the first, the second, the second, the first) and must give
    bitwise-equal outputs. Returns, for each, the runs and the plan the
    kernel picks."""
    import torch

    from multike_tpu_torch.kernels import rank_kernel as rk

    out = []
    for i, ((n1, n2, reps), d, paths) in enumerate(widths):
        turns = paths + paths[::-1] if len(paths) > 1 else paths
        runs = [_rank_shape(dev, peaks, n1, n2, d, reps, 100 + i,
                            time_plain=False, path=path, outputs=True)
                for path in turns]
        outs = [r.pop("outputs") for r in runs]
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for o in outs[1:] for a, b in zip(outs[0], o)),
              f"K2's plans differ at {n1}x{n2} d={d}")
        out.append(dict(n1=n1, n2=n2, d=d,
                        pick=rk.plan(n1, n2, d, device=dev)["path"],
                        runs=runs))
        del outs
        torch.cuda.empty_cache()
    return out


class _Data:
    """A data model with only the KG pair, which is all the relation-view
    streams read."""

    def __init__(self, kgs):
        self.kgs = kgs


def synthetic_pair(n: int) -> str:
    """The synthetic KG pair with ``n`` entities per KG, in the shape of
    benchmarks/quality_at_scale.py (6n relation and 3n attribute triples
    per KG)."""
    from multike_tpu_torch.data import synthetic

    return synthetic.generate(
        os.path.join(REPO, "output", "chip_smoke", f"syn{n}") + "/", seed=11,
        n_entities=n, n_relations=max(8, n // 100),
        n_attributes=max(6, n // 500), n_rel_triples=6 * n,
        n_attr_triples=3 * n)


_KGS = {}


def synthetic_kgs(n: int):
    """The KG pair of ``synthetic_pair(n)``, read once."""
    from multike_tpu_torch.data.kg import read_kgs_from_folder

    if n not in _KGS:
        _KGS[n] = read_kgs_from_folder(synthetic_pair(n), "631/",
                                       "swapping", False)
    return _KGS[n]


def phase_main_path(dev, n=20_000, epochs=4, dim=75, batch=5000):
    """Train through MultiKETrainer on the synthetic pair and evaluate
    through views.valid_metrics; returns the kernels' launch counts."""
    from multike_tpu_torch.config import Config
    from multike_tpu_torch.eval import views
    from multike_tpu_torch.train.trainer import MultiKETrainer

    t0 = time.time()
    folder = synthetic_pair(n)
    kgs = synthetic_kgs(n)
    cfg = Config(training_data=folder, dim=dim, batch_size=batch,
                 neg_triple_num=10, learning_rate=0.01,
                 row_sparse_updates=True, use_pallas_apply=True)
    log(f"[main] {n} entities per KG, data ready in {time.time() - t0:.1f} s")

    _zero_launches()
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
    launches = _launches()
    emb = trainer.current_embeds_device("rv")
    check(tuple(emb.shape) == (kgs.entities_num, dim)
          and bool(emb.isfinite().all()), "rv embeddings not finite")
    log(f"[main] rv valid MRR {before:.4f} -> {after:.4f} (hits@1 {hits1}%) "
        f"after {epochs} epochs in {train_s:.1f} s; launches {launches}")
    check(after > before, f"rv valid MRR did not rise: {before} -> {after}")
    check(all(launches[k] > 0 for k in ("fused_row_adagrad", "rank_count",
                                        "chunk_loss"))
          and launches["conv_score"] == launches["per_slot_loss"] == 0,
          f"a kernel did not launch on the main path, or K4 (no CNN scorer "
          f"on it) or K5 (no per-slot draws) did: {launches}")
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


def phase_parity(dev, n_ent=100_000, epochs=2):
    """bench.py's reference-parity row (bench.py:398-416) on the card:
    batch 5000, per_slot negatives in both phases, Bloom "drop" rejection
    over both KGs' triples; uniform, then truncated with the DWY100K-shaped
    neighbor table (``gpubench.lib.data.neighbor_parts``). Row-sparse on,
    so K1 runs at the per-slot step's shape. Last, one uniform epoch with
    "resample" rejection instead: each step draws its own candidates and
    redraws the ones that test positive, with a host sync after every
    round. Each epoch's loss must be finite and K1 must launch; the drop
    shares and the Bloom passes a step are reported."""
    import numpy as np
    import torch

    from gpubench.lib import data
    from multike_tpu_torch import sampling
    from multike_tpu_torch.config import Config
    from multike_tpu_torch.kernels import apply_kernel as ak
    from multike_tpu_torch.kernels import per_slot_loss as k5
    from multike_tpu_torch.params import init_params
    from multike_tpu_torch.sampling import (build_neighbor_state,
                                            build_triple_filter)
    from multike_tpu_torch.train import streams

    n_tri, n_rel = 6 * n_ent, 500
    tr1, tr2 = data.kg_pair_triples(7, n_ent, (n_tri, n_tri), (n_rel, n_rel))
    t1, t2 = (torch.as_tensor(t, device=dev) for t in (tr1, tr2))
    cfg = Config(dim=75, batch_size=5000, neg_triple_num=10,
                 neg_scheme="per_slot", truncated_neg_scheme="per_slot",
                 row_sparse_updates=True)
    check(cfg.neg_rejection_tries > 0 and cfg.neg_reject_mode == "drop",
          "the parity row rejects true triples by Bloom drop")
    ranges = ((0, n_ent), (n_ent, 2 * n_ent))
    tfilter = build_triple_filter(np.concatenate([tr1, tr2]), device=dev)
    neighbors = build_neighbor_state(
        2 * n_ent, data.neighbor_parts(3, ranges, 0.3, n_ent // 50, dev),
        device=dev)
    params = init_params(cfg, 2 * n_ent, 2 * n_rel, 2, device=dev)
    opt = streams.init_stream_opt_states(cfg, params)["rel_view"]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for phase, with_nbr, mode, runs in (
            ("uniform", False, "drop", epochs),
            ("truncated", True, "drop", epochs),
            ("uniform_resample", False, "resample", 1)):
        epoch, steps, _ = streams.build_rel_view_epoch(
            cfg.replace(neg_reject_mode=mode), n_tri, n_tri, ranges,
            with_neighbors=with_nbr, tfilter=tfilter)
        check(epoch.scheme == "per_slot"
              and epoch.presample == (mode == "drop"),
              "the parity row presamples per-slot draws, unless resampling")
        launches0, k5_launches0, dropped = ak.launches, k5.launches, 0.0
        rounds = []                        # Bloom passes, one sync each
        hits = sampling._slot_hits
        sampling._slot_hits = lambda *a: rounds.append(1) or hits(*a)
        try:
            for _ in range(runs):
                loss = float(epoch(params, opt, gen, t1, t2, neighbors))
                check(np.isfinite(loss), f"parity {phase} epoch loss {loss}")
                if epoch.dropped is not None:
                    dropped += float(epoch.dropped)
        finally:
            sampling._slot_hits = hits
        rec = dict(steps_per_epoch=steps,
                   k1_launches_per_epoch=(ak.launches - launches0) / runs,
                   k5_launches_per_epoch=(k5.launches - k5_launches0) / runs,
                   dropped_share=dropped / (epoch.slots * runs)
                   if mode == "drop" else None,
                   bloom_passes_per_step=len(rounds) / (steps * runs))
        check(rec["k1_launches_per_epoch"] > 0, f"K1 did not launch in the "
              f"parity row's {phase} epochs")
        check(rec["k5_launches_per_epoch"] == 2 * steps, f"K5 launched "
              f"{rec['k5_launches_per_epoch']} times an epoch in the parity "
              f"row's {phase} epochs, not once a KG a step")
        log(f"[parity] {phase}: batch 5000, per_slot, Bloom {mode}"
            + (f" ({100 * rec['dropped_share']:.3f}% of slots dropped)"
               if mode == "drop" else "")
            + f", {steps} steps/epoch, {rec['bloom_passes_per_step']:g} "
            f"Bloom passes a step, {rec['k1_launches_per_epoch']:g} K1 and "
            f"{rec['k5_launches_per_epoch']:g} K5 launches an epoch: {runs} "
            "epochs, losses finite")
        out[phase] = rec
    return out


# The trainer's epoch method of each ITC stream.
ITC_STREAMS = {
    "rel_view": "train_relation_view_1epo",
    "ckge_rel": "train_cross_kg_entity_inference_relation_view_1epo",
    "ckgp_rel": "train_cross_kg_relation_inference_1epo",
    "attr_view": "train_attribute_view_1epo",
    "ckge_attr": "train_cross_kg_entity_inference_attribute_view_1epo",
    "ckga_attr": "train_cross_kg_attribute_inference_1epo",
    "common_space": "train_common_space_learning_1epo",
}


def _count_launches(fn, into: dict, key: str):
    """``fn`` wrapped to add the kernels' launches and the seconds of each
    call under ``key``."""
    def wrapped(*a, **kw):
        before, t0 = _launches(), time.time()
        out = fn(*a, **kw)
        rec = into.setdefault(key, {"calls": 0, **dict.fromkeys(before, 0),
                                    "seconds": []})
        rec["calls"] += 1
        for name, n in _launches().items():
            rec[name] += n - before[name]
        rec["seconds"].append(time.time() - t0)
        return out
    return wrapped


def run_driver(model, stream_methods: dict, evals):
    """``model.run()`` with each stream's epoch method (``stream_methods``:
    stream -> trainer method) and each function of ``eval.views`` named in
    ``evals`` counting the kernels' launches and its seconds. Returns (test
    MRRs, seconds, launches, by stream, by evaluation)."""
    from multike_tpu_torch.eval import views

    by_stream, by_eval = {}, {}
    for stream, meth in stream_methods.items():
        setattr(model, meth, _count_launches(getattr(model, meth), by_stream,
                                             stream))
    saved = {f: getattr(views, f) for f in evals}
    for f in evals:
        setattr(views, f, _count_launches(saved[f], by_eval, f))
    try:
        _zero_launches()
        t0 = time.time()
        results = model.run()
        run_s = time.time() - t0
        launches = _launches()
    finally:
        for f in evals:
            setattr(views, f, saved[f])
    return results, run_s, launches, by_stream, by_eval


def check_driver_run(model, driver: str, stream_methods: dict, launches,
                     by_stream, by_eval) -> dict:
    """What both drivers' runs must show: every stream ran with finite
    losses and launched K1, K4 only in the three attribute streams, K2 once
    per evaluation, K1 nowhere but in the streams, and the embeddings saved
    under ``<output>/<driver>/``. Returns each stream's epochs, seconds and
    K1 launches."""
    import numpy as np

    from multike_tpu_torch.persistence import EMBEDDING_FILES, ID_FILES

    recs = model.metrics.records
    streams_s = {}
    for stream in stream_methods:
        rs = [r for r in recs if r.get("stream") == stream]
        check(rs and all(np.isfinite(r["loss"]) for r in rs),
              f"{stream}: no epoch or a loss that is not finite")
        check(by_stream[stream]["fused_row_adagrad"] > 0,
              f"K1 did not launch in {stream}")
        check((by_stream[stream]["conv_score"] > 0)
              == (stream in ("attr_view", "ckge_attr", "ckga_attr")),
              f"K4 launched {by_stream[stream]['conv_score']} times in "
              f"{stream}: it scores the three attribute streams only")
        secs = [r["seconds"] for r in rs]
        streams_s[stream] = {"epochs": len(rs), "first_s": secs[0],
                             "mean_later_s": float(np.mean(secs[1:]))
                             if len(secs) > 1 else None,
                             "k1_launches": by_stream[stream][
                                 "fused_row_adagrad"]}
    evals = sum(r["calls"] for r in by_eval.values())
    check(launches["rank_count"] == evals > 0,
          f"K2 launches {launches['rank_count']} for {evals} evaluations: "
          f"{by_eval}")
    check(launches["fused_row_adagrad"] == sum(
        r["fused_row_adagrad"] for r in by_stream.values()),
        "K1 launched outside the streams")
    runs = sorted(glob.glob(os.path.join(model.cfg.output, driver, "*",
                                         "*")))
    check(runs and set(os.listdir(runs[-1])) >= {
        f + ".npy" for f in EMBEDDING_FILES} | set(ID_FILES),
        "the saved embeddings are missing")
    return streams_s


def driver_config(n, mode, dim, batch, epochs, **kw):
    """The drivers' configuration on the synthetic pair of ``n`` entities
    per KG: full width, cut to ``epochs`` epochs with the neighbor refresh
    and the soft-alignment start half-way and one evaluation at the end."""
    from multike_tpu_torch.config import Config

    folder = synthetic_pair(n)
    return Config(training_data=folder,
                  output=os.path.join(REPO, "output", "chip_smoke", mode) + "/",
                  word2vec_path=folder + "mini_word2vec.vec", dim=dim,
                  batch_size=batch, entity_batch_size=batch,
                  attribute_batch_size=batch, neg_triple_num=10,
                  learning_rate=0.01, row_sparse_updates="on",
                  encoder_epoch=5, max_epoch=epochs,
                  truncated_freq=epochs // 2,
                  start_predicate_soft_alignment=epochs // 2,
                  start_valid=epochs, eval_freq=epochs, is_save=True, **kw)


def phase_itc(dev, n=20_000, dim=75, batch=5000, epochs=10, cpu_rows=256):
    """The ITC driver through the calls ``cli.main`` makes (DataModel,
    PredicateAlignModel, ``MultiKE_ITC.run``) at full width on the 20K
    pair, cut to ``epochs`` epochs; returns the kernels' launches, the
    phase's numbers and the DataModel."""
    import numpy as np

    from multike_tpu_torch.align.predicates import PredicateAlignModel
    from multike_tpu_torch.data.dataset import DataModel
    from multike_tpu_torch.eval import views
    from multike_tpu_torch.train.itc import MultiKE_ITC

    cfg = driver_config(n, "itc", dim, batch, epochs)
    t0 = time.time()
    data = DataModel(cfg, verbose=True, device=dev)
    datamodel_s = time.time() - t0
    t0 = time.time()
    pam = PredicateAlignModel(data.kgs, cfg)
    predicates_s = time.time() - t0
    log(f"[itc] DataModel {datamodel_s:.2f} s ({len(data.literal_list)} "
        f"literals; parts {data.seconds}), predicate alignment "
        f"{predicates_s:.2f} s")
    host = check_host_helpers(pam, cfg)

    model = MultiKE_ITC(cfg, data, pam, verbose=True, device=dev)
    before = {v: views.valid(model, v) for v in ("rv", "final")}
    results, run_s, launches, by_stream, by_eval = run_driver(
        model, ITC_STREAMS, ("valid_metrics", "test"))
    after = {v: views.valid(model, v) for v in ("rv", "final")}
    log(f"[itc] {epochs} epochs in {run_s:.1f} s; valid MRR before -> "
        f"after: rv {before['rv']:.4f} -> {after['rv']:.4f}, final "
        f"{before['final']:.4f} -> {after['final']:.4f}; test MRR {results}")

    streams_s = check_driver_run(model, "MultiKE_ITC", ITC_STREAMS, launches,
                                 by_stream, by_eval)
    recs = model.metrics.records
    refresh = [r for r in recs if r.get("stream") == "neighbors"]
    rel = [r for r in recs if r.get("stream") == "rel_view"]
    check(refresh and any(r["truncated"] for r in rel),
          "no neighbor refresh, or no truncated rel_view epoch after it")
    check(all(after[v] > before[v] for v in after),
          f"valid MRR did not rise: {before} -> {after}")
    check(set(results) == {"nv", "rv", "av", "final"}
          and all(np.isfinite(v) for v in results.values()),
          f"test MRRs {results}")
    cpu = check_itc_against_cpu(model, cpu_rows)

    numbers = dict(
        entities_per_kg=n, dim=dim, batch=batch, epochs=epochs,
        literals=len(data.literal_list), datamodel_s=datamodel_s,
        datamodel_parts_s=data.seconds,
        predicates_s=predicates_s, host_helpers=host, run_s=run_s,
        streams=streams_s, neighbor_refresh_s=[r["seconds"] for r in refresh],
        truncated_epochs=sum(r["truncated"] for r in rel),
        evals={k: {"calls": r["calls"], "k2_launches": r["rank_count"],
                   "ms": [1e3 * x for x in r["seconds"]]}
               for k, r in by_eval.items()},
        valid_before=before, valid_after=after, test_mrr=results,
        launches=launches, card_vs_cpu=cpu)
    log(f"[itc] {json.dumps(numbers)}")
    return launches, numbers, data


def check_host_helpers(pam, cfg) -> dict:
    """The host helpers that prepared phase 6: the library loaded is the
    package's own, built under its ``build/``, no other build of the
    helpers (such as the JAX package's) is mapped, and on phase 6's own
    predicate names and ``.vec`` file both helpers are bitwise their plain
    Python versions."""
    import numpy as np

    import multike_tpu_torch
    from multike_tpu_torch.kernels import _build
    from multike_tpu_torch.utils import native

    lib = _build.load_host()._name
    build = os.path.join(os.path.dirname(multike_tpu_torch.__file__),
                         "build") + os.sep
    check(lib.startswith(build), f"host helpers loaded from {lib}")
    with open("/proc/self/maps") as f:
        stray = {p for p in (ln.split()[-1] for ln in f)
                 if os.path.basename(p).startswith("libmultike")
                 and not p.startswith(build)}
    check(not stray, f"libraries mapped from outside {build}: {stray}")
    out = {"library": os.path.relpath(lib, REPO)}
    for kind in ("relation", "attribute"):
        names1 = list(getattr(pam, f"{kind}_name_dict1").values())
        names2 = list(getattr(pam, f"{kind}_name_dict2").values())
        t0 = time.time()
        got = native.levenshtein_ratio_matrix(names1, names2)
        built_s = time.time() - t0
        t0 = time.time()
        want = native.lev_ratio_matrix_py(names1, names2)
        py_s = time.time() - t0
        check(got.shape == (len(names1), len(names2))
              and np.array_equal(got, want),
              f"the {kind} Levenshtein matrix differs from the plain one")
        out[f"{kind}_levenshtein"] = {"shape": list(got.shape),
                                      "built_s": built_s, "python_s": py_s}
    t0 = time.time()
    got = native.read_word2vec(cfg.word2vec_path, cfg.word2vec_dim)
    built_s = time.time() - t0
    t0 = time.time()
    want = native.read_word2vec_py(cfg.word2vec_path, cfg.word2vec_dim)
    py_s = time.time() - t0
    check(got and list(got) == list(want)
          and all(np.array_equal(got[w], want[w]) for w in want),
          "the .vec reader differs from the plain one")
    out["vec"] = {"words": len(got), "built_s": built_s, "python_s": py_s}
    log(f"[itc] host helpers: {json.dumps(out)}")
    return out


def _copy_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def step_on_card_and_cpu(model, stream, step, state, batch, constants=None,
                         label=None, reads=(), tables=None):
    """One injected step of ``stream`` from the trained tables (or
    ``tables``) and ``state``, on the card and on the CPU (the kernels'
    plain versions): the loss and every variable and state tensor must
    agree to rtol 3e-5 / atol 1e-6. ``reads``: tables the step reads
    without training them."""
    import torch

    from multike_tpu_torch.train import streams

    names = streams.STREAM_VARS[stream] + tuple(reads)
    tables = model.params if tables is None else tables
    res = []
    for dev in (model.device, torch.device("cpu")):
        params = _copy_to({k: tables[k] for k in names}, dev)
        st = _copy_to(state, dev)
        lead = () if constants is None else (_copy_to(constants, dev),)
        loss = step(params, st, *lead,
                    *(None if x is None else x.to(dev) for x in batch))
        res.append((float(loss), [t.cpu() for t in streams._leaves(
            params) + streams._leaves(st)]))
    (l_card, t_card), (l_cpu, t_cpu) = res
    excess = max(float(((g - w).abs() - (1e-6 + 3e-5 * w.abs())).max())
                 for g, w in zip(t_card, t_cpu) if g.is_floating_point())
    check(all(torch.equal(g, w) for g, w in zip(t_card, t_cpu)
              if not g.is_floating_point()),
          f"{label or stream}: an integer state differs between card and CPU")
    check(excess <= 0 and abs(l_card - l_cpu) <= 3e-5 * abs(l_cpu),
          f"a {label or stream} step on the card differs from the CPU's: "
          f"loss {l_card} vs {l_cpu}, worst excess over tolerance "
          f"{excess:.3e}")
    return {"loss_card": l_card, "loss_cpu": l_cpu, "worst_excess": excess}


def check_itc_against_cpu(model, rows: int):
    """From the trained state, one attr_view step and one common_space step
    on the card and on the CPU agree to rtol 3e-5 / atol 1e-6, and a fresh
    neighbor refresh on the card gives the CPU's top-k on the first
    ``rows`` useful entities of KG1 (a differing id must score within 1e-5
    of the row's k-th score)."""
    import torch

    from multike_tpu_torch.params import l2_normalize
    from multike_tpu_torch.train import streams

    cfg, gen = model.cfg, model.gen
    t1, f1, t2, f2 = model._weighted_attr_arrays()
    attr, _, _ = streams.build_attr_view_epoch(cfg, len(t1), len(t2))
    ents = model._cached_array("common_space_ents",
                               model.kgs.kg1.entities_list
                               + model.kgs.kg2.entities_list)
    common, _, _ = streams.build_common_space_epoch(cfg, len(ents))
    sel = torch.randperm(len(ents), generator=gen,
                         device=gen.device)[:common.bs]
    cases = {"attr_view": (attr.step, [x[0] for x in attr.draw(
                 gen, t1, f1, t2, f2)]),
             "common_space": (common.step, [ents[sel]])}
    worst = {stream: step_on_card_and_cpu(
                 model, stream, step, model.opt_states[stream], batch,
                 constants=model.constants)
             for stream, (step, batch) in cases.items()}

    model.generate_neighbors()
    kgs, k = model.kgs, min(model.k_nbr1, len(model.kgs.useful_entities_list1))
    u = torch.as_tensor(kgs.useful_entities_list1, dtype=torch.long)
    rv = l2_normalize(model.params["rv_ent"], axis=1).cpu()[u]
    s = rv[:rows] @ rv.T
    top = torch.topk(s, k, dim=1)
    col_of = {int(e): j for j, e in enumerate(u.tolist())}
    card = model.neighbors.nbr[u[:rows].to(model.device), :k].cpu()
    differing = 0
    for r in range(rows):
        got, want = set(card[r].tolist()), set(u[top.indices[r]].tolist())
        for e in got ^ want:
            differing += 1
            check(abs(float(s[r, col_of[e]]) - float(top.values[r, -1]))
                  <= 1e-5, f"neighbor row {r}: id {e} is no tie at the k-th "
                  "score")
    log(f"[itc] card vs CPU: attr_view and common_space steps agree "
        f"({worst}); neighbor ids of {rows} rows (k={k}) equal but for "
        f"{differing} ties at the k-th score")
    return dict(steps=worst, neighbor_rows=rows, k=k,
                neighbor_tie_swaps=differing)


# The trainer's epoch method of each SSL stream.
SSL_STREAMS = {**{k: v for k, v in ITC_STREAMS.items() if k != "common_space"},
               "space_mapping": "train_shared_space_mapping_1epo"}
SSL_EVALS = ("valid_metrics", "test", "valid_WVA", "test_WVA")


def phase_ssl(dev, data, n=20_000, dim=75, batch=5000, epochs=10):
    """The SSL driver through the calls ``cli.main`` makes (phase 6's
    DataModel, a fresh PredicateAlignModel, ``MultiKE_SSL.run``) at full
    width on the 20K pair: per-slot draws with Bloom "drop" rejection in
    both phases, ``epochs`` epochs of phase 1 (refresh and soft-alignment
    start half-way, one evaluation at the end) and ``epochs`` of phase 2
    (one ``final`` valid). Returns the kernels' launches and the numbers."""
    import numpy as np

    from multike_tpu_torch.align.predicates import PredicateAlignModel
    from multike_tpu_torch.eval import views
    from multike_tpu_torch.train.ssl import MultiKE_SSL

    cfg = driver_config(n, "ssl", dim, batch, epochs,
                        shared_learning_max_epoch=epochs,
                        neg_scheme="per_slot", truncated_neg_scheme="per_slot")
    check(cfg.neg_rejection_tries > 0 and cfg.neg_reject_mode == "drop",
          "phase 7 rejects true triples by Bloom drop")
    t0 = time.time()
    pam = PredicateAlignModel(data.kgs, cfg)
    predicates_s = time.time() - t0
    model = MultiKE_SSL(cfg, data, pam, verbose=True, device=dev)
    check(model.triple_filter is not None, "no Bloom filter was built")
    # phase 1 does not train `ent`, so `final` before the run is `final`
    # before phase 2
    before = {v: views.valid(model, v) for v in ("rv", "avg", "final")}
    results, run_s, launches, by_stream, by_eval = run_driver(
        model, SSL_STREAMS, SSL_EVALS)
    after = {v: views.valid(model, v) for v in ("rv", "avg", "final")}
    log(f"[ssl] {epochs} + {epochs} epochs in {run_s:.1f} s; valid MRR "
        f"before -> after: " + ", ".join(
            f"{v} {before[v]:.4f} -> {after[v]:.4f}" for v in before)
        + f"; test MRR {results}")

    streams_s = check_driver_run(model, "MultiKE_SSL", SSL_STREAMS, launches,
                                 by_stream, by_eval)
    check(all(r["rank_count"] == r["calls"] for r in by_eval.values()),
          f"K2 launches by evaluation: {by_eval}")
    check(by_stream["rel_view"]["per_slot_loss"] == launches["per_slot_loss"]
          > 0, f"K5 launched {launches['per_slot_loss']} times, "
          f"{by_stream['rel_view']['per_slot_loss']} in rel_view: the per-slot "
          "loss is the SSL rel_view's")
    check(by_eval["valid_WVA"]["calls"] == 1 and
          by_eval["test_WVA"]["calls"] == 1, "WVA was not evaluated")
    recs = model.metrics.records
    rel = [r for r in recs if r.get("stream") == "rel_view"]
    check(all(r["scheme"] == "per_slot" for r in rel)
          and {r["truncated"] for r in rel} == {False, True},
          "per-slot rel_view epochs must run before and after the refresh")
    drops = {ph: [r["dropped_share"] for r in rel if r["truncated"] == tr]
             for ph, tr in (("uniform", False), ("truncated", True))}
    log(f"[ssl] Bloom drop share of rel_view slots: uniform "
        f"{[round(x, 6) for x in drops['uniform']]}, truncated "
        f"{[round(x, 6) for x in drops['truncated']]}")
    check(all(after[v] > before[v] for v in after),
          f"valid MRR did not rise: {before} -> {after}")
    check(set(results) == {"nv", "rv", "av", "avg", "wva", "final"}
          and all(np.isfinite(v) for v in results.values()),
          f"test MRRs {results}")
    cpu = check_ssl_against_cpu(model)
    numbers = dict(
        entities_per_kg=n, dim=dim, batch=batch, epochs=epochs,
        shared_learning_epochs=epochs, predicates_s=predicates_s,
        run_s=run_s, streams=streams_s,
        neighbor_refresh_s=[r["seconds"] for r in recs
                            if r.get("stream") == "neighbors"],
        dropped_share=drops,
        evals={k: {"calls": r["calls"], "k2_launches": r["rank_count"],
                   "ms": [1e3 * x for x in r["seconds"]]}
               for k, r in by_eval.items()},
        valid_before=before, valid_after=after, test_mrr=results,
        launches=launches, card_vs_cpu=cpu)
    log(f"[ssl] {json.dumps(numbers)}")
    return launches, numbers


def check_ssl_against_cpu(model, probes=1_000_000):
    """From the trained state, on the card and on the CPU: the Bloom words
    and membership on the true triples and ``probes`` random ones are
    bit-equal; one truncated per-slot rel_view step with its keep mask, one
    space_mapping step and one dense ckge_rel step each of Adam, Adadelta
    and SGD agree to rtol 3e-5 / atol 1e-6. Each optimizer's step starts
    from the state of three earlier steps on the card: from a fresh state
    Adam's update is g / (|g| + 1e-8) per element, which turns the
    summation-order noise of a near-zero gradient into most of a step of
    lr, on either device."""
    import numpy as np
    import torch

    from multike_tpu_torch.sampling import (build_triple_filter,
                                            triple_filter_contains)
    from multike_tpu_torch.train import optimizers, streams

    cfg, gen, kgs = model.cfg, model.gen, model.kgs
    true = torch.cat([model.rel_triples1, model.rel_triples2]).cpu()
    host = build_triple_filter(true.numpy(), device="cpu")
    card = model.triple_filter
    check(torch.equal(card.bits.cpu(), host.bits),
          "the Bloom words on the card differ from the CPU's")
    rng = np.random.RandomState(5)
    probe = torch.cat([true, torch.as_tensor(np.stack(
        [rng.randint(0, kgs.entities_num, probes),
         rng.randint(0, kgs.relations_num, probes),
         rng.randint(0, kgs.entities_num, probes)], 1))])
    got = triple_filter_contains(card, *probe.to(model.device).T).cpu()
    want = triple_filter_contains(host, *probe.T)
    check(torch.equal(got, want), "Bloom membership differs on the card")
    check(bool(want[:len(true)].all()), "a true triple tested negative")
    fp_rate = float(want[len(true):].float().mean())

    steps = {}
    rel, _, _ = streams.build_rel_view_epoch(
        cfg, model.n_rel1, model.n_rel2, model.ranges, with_neighbors=True,
        tfilter=card)
    xs = [x[0] for x in rel.draw(gen, model.rel_triples1,
                                 model.rel_triples2, model.neighbors)]
    dropped = int((xs[4] == 0).sum() + (xs[9] == 0).sum())
    steps["rel_view"] = step_on_card_and_cpu(
        model, "rel_view", rel.step, model.opt_states["rel_view"], xs)
    ents = model._cached_array("space_mapping_ents",
                               kgs.kg1.entities_list + kgs.kg2.entities_list)
    sm, _, _ = streams.build_space_mapping_epoch(cfg, len(ents))
    sel = torch.randperm(len(ents), generator=gen, device=gen.device)[:sm.bs]
    steps["space_mapping"] = step_on_card_and_cpu(
        model, "space_mapping", sm.step, model.opt_states["space_mapping"],
        [ents[sel]], constants=model.constants, reads=("rv_ent", "av_ent"))
    sup = model._cached_array("ckge_rel", kgs.kg1.sup_relation_triples_list
                              + kgs.kg2.sup_relation_triples_list)
    for name in ("Adam", "Adadelta", "SGD"):
        ocfg = cfg.replace(optimizer=name)
        ep, _, _ = streams.build_ckge_rel_epoch(ocfg, len(sup))
        tables = _copy_to({k: model.params[k] for k in
                           streams.STREAM_VARS["ckge_rel"]}, model.device)
        state = optimizers.init_state(name, tables)
        sel = torch.randperm(len(sup), generator=gen,
                             device=gen.device)[:ep.bs]
        for _ in range(3):
            ep.step(tables, state, sup[sel])
        steps[name] = step_on_card_and_cpu(model, "ckge_rel", ep.step, state,
                                           [sup[sel]], label=name,
                                           tables=tables)
    log(f"[ssl] card vs CPU: Bloom words and membership of "
        f"{len(probe):,} triples bit-equal (false-positive rate "
        f"{fp_rate:.2e}); steps agree ({steps}); the rel_view step's keep "
        f"mask drops {dropped} slots")
    return dict(bloom_probes=len(probe), bloom_fp_rate=fp_rate,
                rel_view_dropped_slots=dropped, steps=steps)


# ---------------------------------------------------------------------------
# phase 8: the mesh, in rank processes
# ---------------------------------------------------------------------------

MESH_DIR = os.path.join(REPO, "output", "chip_smoke", "mesh")


def spawn_ranks(task: str, n: int, spec: dict, timeout: float):
    """Runs mesh task ``task`` in ``n`` fresh processes of this script
    (``--mesh-rank``), ranks 0..n-1 of one world joined through a file
    store. Returns (every rank's result in rank order, seconds). A rank
    that fails fails the run at once, one that outlives ``timeout`` too;
    no rank outlives the call."""
    folder = os.path.join(MESH_DIR, f"{task}_{n}")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    spec = dict(spec, out=folder, timeout=timeout,
                store="file://" + os.path.join(folder, "store"))
    path = os.path.join(folder, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    # the ranks share the host's cores; the loopback carries the
    # rendezvous sockets of gloo and NCCL; the cuBLAS workspace setting is
    # the one its deterministic mode needs (task world1)
    env = dict(os.environ, WORLD_SIZE=str(n), GLOO_SOCKET_IFNAME="lo",
               NCCL_SOCKET_IFNAME="lo", CUBLAS_WORKSPACE_CONFIG=":4096:8",
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 8) // n)))
    procs, logs = [], []
    t0 = time.time()
    for r in range(n):
        logs.append(os.path.join(folder, f"rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 task, path], cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() - t0 > timeout:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    secs = time.time() - t0
    for r, (p, lp) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(lp, errors="replace") as f:
                tail = f.read()[-3000:]
            raise SmokeFailure(
                f"mesh {task}: rank {r} of {n} exited with {p.returncode} "
                f"after {secs:.1f} s (timeout {timeout} s):\n{tail}")
    results = []
    for r in range(n):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, secs


def _kernel_modules() -> dict:
    """Each kernel's name in the kernels line -> its wrapper's module, whose
    ``launches`` counts its launches."""
    from multike_tpu_torch.kernels import apply_kernel as ak
    from multike_tpu_torch.kernels import chunk_loss as ck
    from multike_tpu_torch.kernels import conv_score as k4
    from multike_tpu_torch.kernels import per_slot_loss as k5
    from multike_tpu_torch.kernels import rank_kernel as rk

    return {"fused_row_adagrad": ak, "rank_count": rk, "chunk_loss": ck,
            "conv_score": k4, "per_slot_loss": k5}


def _launches():
    return {name: m.launches for name, m in _kernel_modules().items()}


def _zero_launches():
    for m in _kernel_modules().values():
        m.launches = 0


def _excess(got, want, rtol, atol) -> float:
    """The largest amount by which |got - want| passes atol + rtol |want|
    (<= 0: within tolerance)."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _ring_inputs(n1, n2, d, seed):
    """Host (numpy) rows of both sides, aligned pairs, unit rows."""
    import numpy as np

    rng = np.random.RandomState(seed)
    e1 = rng.randn(n1, d).astype(np.float32)
    e2 = rng.randn(n2, d).astype(np.float32)
    e2[:n1] += 0.5 * e1
    return (e1 / np.linalg.norm(e1, axis=1, keepdims=True),
            e2 / np.linalg.norm(e2, axis=1, keepdims=True))


def _ring_against_plain(d1, d2, ring, r2=None):
    """The ring's ``(count, best)`` against K2's plain version on the whole
    matrix (gold: column i; CSLS with the penalties ``r2``, computed apart
    from the ring): mismatches only on rows within 1e-6 of a tie (a check
    fails otherwise). Returns (count mismatches, argmax mismatches, tie
    rows)."""
    import torch

    from multike_tpu_torch.kernels import rank_kernel as rk

    n1 = d1.shape[0]
    gold = torch.sum(d1 * d2[:n1], dim=1)
    if r2 is not None:
        gold = 2.0 * gold - r2[:n1]
    gidx = torch.arange(n1, dtype=torch.int32, device=d1.device)
    want = rk.rank_count_plain(d1, gold.contiguous(), gidx, d2, r2)
    got = [torch.as_tensor(x, device=d1.device) for x in ring]
    return _rank_compare(d1, d2, gold, r2, got, want)


def _blocks_against_plain(e1, gold, gidx, e2, r2, blocks):
    """K2 against its plain version on column blocks ``(col0, width)`` of
    ``e2``, called as a ring step calls it: gold ids shifted by ``col0``,
    so they fall below 0, inside the block or at its width and beyond.
    Mismatches only on rows within 1e-6 of a tie (a check fails otherwise);
    returns [count mismatches, argmax mismatches, tie rows, best_val
    max_abs_err] per block."""
    import torch

    from multike_tpu_torch.kernels import rank_kernel as rk

    out = []
    for col0, width in blocks:
        g = (gidx - col0).to(torch.int32)
        blk = e2[col0:col0 + width].contiguous()
        rb = None if r2 is None else r2[col0:col0 + width].contiguous()
        got = rk.rank_count(e1, gold, g, blk, rb)
        want = rk.rank_count_plain(e1, gold, g, blk, rb)
        err = float((got[2] - want[2]).abs().max())
        check(err <= 1e-5, f"K2 block at column {col0}: best_val differs "
              f"from the plain version by {err:.3e}")
        out.append([*_rank_compare(e1, blk, gold, rb, got, want, g), err])
    return out


def mesh_task_world1(spec):
    """(a) One rank: a process group of size 1 on ``spec["backend"]`` (NCCL
    on the card) and a ``MeshContext`` of dp = tp = 1 built directly, so
    the mesh's collectives run through the backend. One epoch of each of
    the 8 streams, and the ring with and without CSLS; then the same
    without a mesh, compared."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from multike_tpu_torch.config import Config
    from multike_tpu_torch.eval.alignment import rank_and_align
    from multike_tpu_torch.eval.ring import ring_rank_and_align
    from multike_tpu_torch.eval.similarity import csls_penalties_blockwise
    from multike_tpu_torch.parallel import distributed, spmd
    from multike_tpu_torch.parallel.context import MeshContext
    from multike_tpu_torch.parallel.mesh import make_mesh
    from multike_tpu_torch.train import streams

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the atomic sums of the dedup and of the gathers' backward add in
    # another order each run; the deterministic ones make the two runs
    # comparable bit for bit (an op without one warns in the rank's log)
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group(
        spec["backend"], init_method=spec["store"], world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    pctx = MeshContext(make_mesh(1, 1), dev)
    cfg = Config(**spec["cfg"])
    h1, h2 = _ring_inputs(*spec["ring"], seed=5)
    csls = (0, spec["csls_k"])

    _zero_launches()
    t0 = time.time()
    losses, tables = spmd.run_streams(cfg, pctx, dev, **spec["sizes"])
    ring = [ring_rank_and_align(pctx.dp_group, h1, h2, csls_k=k, device=dev)
            for k in csls]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.time() - t0
    launches = _launches()
    transport = distributed.transport(pctx.dp_group)

    want_losses, want_tables = spmd.run_streams(cfg, None, dev,
                                                **spec["sizes"])
    one = [rank_and_align(h1, h2, csls_k=k, device=dev) for k in csls]
    # the ring's one block against K2's plain version, on the rows the ring
    # normalized on the host (eval/ring.py)
    d1, d2 = (torch.as_tensor(x / np.maximum(np.linalg.norm(
        x, axis=1, keepdims=True), 1e-30), device=dev) for x in (h1, h2))
    plain = [_ring_against_plain(
        d1, d2, r, csls_penalties_blockwise(d1, d2, k)[1] if k else None)
        for k, r in zip(csls, ring)]
    loss_excess = max(abs(losses[k] - v) - (1e-6 + 1e-5 * abs(v))
                      for k, v in want_losses.items())
    table_excess = {k: max(_excess(a, b, 1e-5, 1e-6) for a, b in zip(
        streams._leaves(tables[k]), streams._leaves(want_tables[k])))
        for k in tables}
    dist.destroy_process_group()
    return dict(transport=transport, launches=launches, seconds=secs,
                losses=losses, want_losses=want_losses,
                loss_excess=loss_excess, table_excess=table_excess,
                ring_equal=[bool(np.array_equal(a[0], b[0]) and
                                 np.array_equal(a[1], b[1]))
                            for a, b in zip(ring, one)],
                ring_plain=plain, staged=distributed.staged)


def mesh_task_dryrun(spec):
    """(b) ``spmd.main``, the package's own dryrun entry point, on this
    world of ranks."""
    from multike_tpu_torch.parallel import distributed, spmd

    _zero_launches()
    t0 = time.time()
    metrics = spmd.main(["--dp", str(spec["dp"]), "--tp", str(spec["tp"]),
                         "--device", spec["device"], "--dist-backend",
                         spec["backend"], "--dist-init", spec["store"]])
    return dict(metrics=metrics, launches=_launches(),
                seconds=time.time() - t0, staged=distributed.staged)


def mesh_task_ring(spec):
    """(b) ``ring_rank_and_align`` over this world, with and without CSLS,
    timed on each rank. Then, on rank 0 and outside the counted run: one K2
    call on the whole matrix from the ring's own gold and CSLS penalties,
    which must give the same counts and argmax (the blocks' merge); K2's
    plain version on the whole matrix with the one-rank engine's penalties
    (``csls_penalties_blockwise``, apart from the ring's top-k pass), which
    may differ only on ties; K2 against its plain version on rank 0's ring
    blocks and on one block whose shifted gold ids fall below 0, inside and
    beyond it. The ring's penalties must lie within 1e-6 of the one-rank
    engine's (another order of the top-k merge and other matmul shapes, so
    not bit-equal in general)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from multike_tpu_torch.eval.ring import (make_ring_topk_means,
                                             ring_rank_and_align)
    from multike_tpu_torch.eval.similarity import csls_penalties_blockwise
    from multike_tpu_torch.kernels import rank_kernel as rk
    from multike_tpu_torch.parallel import distributed

    dev = torch.device(spec["device"])
    distributed.init_distributed(backend=spec["backend"], device=dev,
                                 init_method=spec["store"],
                                 timeout_s=spec["timeout"])
    group, P = dist.group.WORLD, distributed.world_size()
    n1, n2, d = spec["shape"]
    check(n1 % P == 0 and n2 % P == 0, "ring shape must split evenly")
    h1, h2 = _ring_inputs(n1, n2, d, seed=7)
    out = {"transport": distributed.transport(group), "ms": {}}
    runs = {}
    _zero_launches()
    for k in (0, spec["csls_k"]):
        ring_rank_and_align(group, h1, h2, normalize=False, csls_k=k,
                            device=dev)                      # warm-up
        ms = []
        for _ in range(spec["reps"]):
            dist.barrier()
            t0 = time.perf_counter()
            runs[k] = ring_rank_and_align(group, h1, h2, normalize=False,
                                          csls_k=k, device=dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        out["ms"][k] = ms
    out["launches"] = _launches()
    out["staged"] = distributed.staged

    # the reference, outside the counted run: the ring's gold and, under
    # CSLS, its penalties r2 (a ring pass of its own on every rank)
    d1 = torch.as_tensor(h1, device=dev)
    d2 = torch.as_tensor(h2, device=dev)
    gold0 = torch.sum(d1 * d2[:n1], dim=1)
    gidx = torch.arange(n1, dtype=torch.int32, device=dev)
    b1 = distributed.block_slice(n1, P, distributed.rank())
    b2 = distributed.block_slice(n2, P, distributed.rank())
    r2 = distributed.all_gather(make_ring_topk_means(
        group, spec["csls_k"], n_valid=n1)(d2[b2], d1[b1]), group)
    me = distributed.rank()
    distributed.shutdown()
    if me != 0:
        return out
    _, r2_one = csls_penalties_blockwise(d1, d2, spec["csls_k"])
    out["r2_max_abs_diff"] = float((r2 - r2_one).abs().max())
    nb = n2 // P
    # rank 0's ring steps, then a block holding gold ids of every kind
    blocks = [(p * nb, nb) for p in range(P)] + [(n1 // 4, n1 // 2)]
    for key in ("equal", "mismatches", "mean_rank", "plain", "blocks"):
        out[key] = {}
    for k, (gold, pen, pen_one) in (
            (0, (gold0, None, None)),
            (spec["csls_k"], (2.0 * gold0 - r2[:n1], r2, r2_one))):
        gold = gold.contiguous()
        cnt, best, _ = rk.rank_count(d1, gold, gidx, d2, pen)
        cnt, best = cnt.cpu().numpy(), best.cpu().numpy()
        got_c, got_b = runs[k]
        out["mismatches"][k] = [int((got_c != cnt).sum()),
                                int((got_b != best).sum())]
        out["equal"][k] = bool(np.array_equal(got_c, cnt)
                               and np.array_equal(got_b, best))
        out["mean_rank"][k] = float(cnt.mean())
        out["plain"][k] = _ring_against_plain(d1, d2, runs[k], pen_one)
        rows = [b1] * P + [slice(0, n1)]
        out["blocks"][k] = [_blocks_against_plain(
            d1[r].contiguous(), gold[r].contiguous(), gidx[r].contiguous(),
            d2, pen, [b])[0] for r, b in zip(rows, blocks)]
    out["block_spans"] = blocks
    return out


def mesh_task_cli(spec):
    """``cli.main`` on ``spec["argv"]`` (the rendezvous added on a world
    of more than one rank); its launches, result and seconds."""
    from multike_tpu_torch import cli
    from multike_tpu_torch.parallel import distributed

    argv = list(spec["argv"])
    if int(os.environ["WORLD_SIZE"]) > 1:
        argv += ["--dist-init", spec["store"]]
    _zero_launches()
    t0 = time.time()
    results = cli.main(argv)
    out = dict(results=results, launches=_launches(),
               seconds=time.time() - t0, staged=distributed.staged,
               transport=distributed.transport()
               if distributed.is_multiprocess() else "none")
    distributed.shutdown()
    return out


MESH_TASKS = {"world1": mesh_task_world1, "dryrun": mesh_task_dryrun,
              "ring": mesh_task_ring, "cli": mesh_task_cli}


def mesh_rank(task: str, spec_path: str) -> int:
    """One rank process of phase 8: runs ``task`` and writes its result."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    import multike_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)

    out = MESH_TASKS[task](spec)
    with open(os.path.join(spec["out"],
                           f"rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def cli_files(cfg, folder: str):
    """``cfg`` as an ``--args`` file in a fresh ``folder``; returns its path
    and the path of the run's metrics log there."""
    import dataclasses

    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    args = os.path.join(folder, "args.json")
    with open(args, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    return args, os.path.join(folder, "metrics.jsonl")


def _stream_losses(path):
    """{(stream, epoch): (loss, seconds)} of a metrics log's epochs."""
    recs = {}
    with open(path) as f:
        for ln in f:
            r = json.loads(ln)
            if "loss" in r and r.get("epoch") is not None:
                recs[(r["stream"], r["epoch"])] = (r["loss"], r["seconds"])
    return recs


def phase_mesh(dev, card, n=20_000, dim=75, batch=5000, epochs=10,
               ring_shape=(35_000, 70_000), world1_sizes=None,
               world1_ring=(6_000, 12_000), csls_k=10, timeout=300):
    """Phase 8 (see the module's docstring). Returns the kernels' launches
    summed over the mesh runs' ranks, each run's per rank, and the
    numbers."""
    import numpy as np
    import torch

    from multike_tpu_torch.parallel import spmd

    if dev.type == "cuda":
        torch.cuda.empty_cache()       # the earlier phases' cached blocks
    one_backend = "nccl" if dev.type == "cuda" else "gloo"
    log(f"[mesh] the ranks below share one card ({card}): their times say "
        "nothing about scaling across cards")
    by_rank, numbers = {}, {}

    # (a) NCCL at world size 1
    sizes = world1_sizes or dict(entities=2 * n, relations=400,
                                 attributes=120, literals=n, n_tri=6 * n,
                                 n_ents=2 * n)
    cfg = dict(dim=dim, batch_size=batch, entity_batch_size=batch,
               attribute_batch_size=batch, neg_triple_num=10,
               learning_rate=0.01, row_sparse_updates="on")
    [w1], secs = spawn_ranks("world1", 1, dict(
        device=str(dev), backend=one_backend, cfg=cfg, sizes=sizes,
        ring=(*world1_ring, dim), csls_k=csls_k), timeout)
    by_rank["world1"] = [w1["launches"]]
    log(f"[mesh] (a) {w1['transport']} at world size 1, dp = tp = 1: 8 "
        f"stream epochs and the ring in {w1['seconds']:.2f} s ({secs:.1f} s "
        f"with the process); losses {w1['losses']}; worst excess over rtol "
        f"1e-5 / atol 1e-6: losses {w1['loss_excess']:.3e}, tables "
        f"{w1['table_excess']}; ring == rank_and_align (CSLS off, k="
        f"{csls_k}): {w1['ring_equal']}; ring against K2's plain version "
        f"(count mismatches, argmax mismatches, tie rows) "
        f"{w1['ring_plain']}; launches {w1['launches']}")
    check(w1["transport"] == one_backend, f"world1 ran on {w1['transport']}")
    check(w1["loss_excess"] <= 0 and max(w1["table_excess"].values()) <= 0,
          "(a) the mesh epochs at world size 1 differ from the epochs "
          "without a mesh")
    check(all(w1["ring_equal"]), "(a) the ring differs from rank_and_align")
    check(w1["staged"] == 0 or one_backend == "gloo", "NCCL staged a tensor")
    numbers["world1"] = {k: w1[k] for k in ("transport", "seconds", "losses",
                                            "loss_excess", "table_excess",
                                            "ring_equal", "ring_plain")}

    # (b) gloo ranks sharing the card: the dryrun at 2 x 2
    t0 = time.time()
    want = spmd.dryrun(1, 1, device=dev)
    one_s = time.time() - t0
    ranks, secs = spawn_ranks("dryrun", 4, dict(
        device=str(dev), backend="gloo", dp=2, tp=2), timeout)
    by_rank["dryrun_2x2"] = [r["launches"] for r in ranks]
    got = ranks[0]["metrics"]
    worst = max(abs(got[k] - v) / abs(v) for k, v in want.items())
    log(f"[mesh] (b) dryrun dp=2 x tp=2 on 4 gloo ranks: {got} in "
        f"{[round(r['seconds'], 2) for r in ranks]} s per rank ({secs:.1f} s "
        f"with the processes; 1 rank {one_s:.2f} s); worst relative "
        f"difference from 1 rank {worst:.3e}; staged collectives per rank "
        f"{[r['staged'] for r in ranks]}; launches per rank "
        f"{by_rank['dryrun_2x2']}")
    check(all(np.isclose(r["metrics"][k], v, rtol=1e-6)
              for r in ranks for k, v in got.items()),
          "the dryrun's ranks disagree")
    check(set(got) == set(want) | {"eval_rows"} and worst <= 1e-3,
          f"dryrun at 2 x 2 differs from 1 rank beyond rtol 1e-3: {got} vs "
          f"{want}")
    numbers["dryrun_2x2"] = dict(metrics=got, one_rank=want,
                                 worst_rel_diff=worst,
                                 seconds=[r["seconds"] for r in ranks])

    # (b) the ring over 2 ranks
    ranks, secs = spawn_ranks("ring", 2, dict(
        device=str(dev), backend="gloo", shape=(*ring_shape, dim),
        csls_k=csls_k, reps=3), timeout)
    by_rank["ring_2"] = [r["launches"] for r in ranks]
    r0 = ranks[0]
    ring_ms = {k: [float(np.median(r["ms"][k])) for r in ranks]
               for k in r0["ms"]}
    log(f"[mesh] (b) ring {ring_shape[0]}x{ring_shape[1]} d={dim} on 2 "
        f"{r0['transport']} ranks: median ms per call on each rank, CSLS "
        f"off {ring_ms['0']}, k={csls_k} {ring_ms[str(csls_k)]}; counts and "
        f"argmax mismatches against one K2 call {r0['mismatches']}; mean "
        f"rank {r0['mean_rank']}; ring r2 vs one-rank r2 max abs diff "
        f"{r0['r2_max_abs_diff']:.3e}; launches per rank {by_rank['ring_2']}")
    log(f"[mesh]   against K2's plain version (count mismatches, argmax "
        f"mismatches, tie rows): whole matrix, one-rank CSLS penalties "
        f"{r0['plain']}; column blocks {r0['block_spans']} (rank 0's ring "
        f"steps, then gold ids below 0, inside and beyond) with best_val "
        f"max_abs_err {r0['blocks']}")
    check(all(r0["equal"].values()), "the ring differs from one K2 call")
    check(r0["r2_max_abs_diff"] <= 1e-6, "the ring's CSLS penalties differ "
          "from the one-rank engine's by more than 1e-6")
    numbers["ring_2"] = dict(shape=ring_shape, ms_per_rank=ring_ms,
                             mean_rank=r0["mean_rank"],
                             r2_max_abs_diff=r0["r2_max_abs_diff"],
                             plain=r0["plain"], blocks=r0["blocks"],
                             staged=[r["staged"] for r in ranks])

    # (b) the ITC driver through the CLI: one rank, then dp=2
    runs = {}
    for label, world in (("one", 1), ("dp2", 2)):
        cfg = driver_config(n, f"mesh_{label}", dim, batch, epochs,
                            retrain_literal_embeds=False)
        args, metrics = cli_files(cfg, os.path.join(MESH_DIR, f"cli_{label}"))
        argv = ["-m", "ITC", "-d", cfg.training_data, "--args", args,
                "--device", str(dev), "--set", f"metrics_log_path={metrics}"]
        if world > 1:
            argv += ["--set", f"mesh_dp={world}", "--dist-backend", "gloo"]
        ranks, secs = spawn_ranks("cli", world, dict(argv=argv), timeout)
        runs[label] = (ranks, secs, _stream_losses(metrics))
    (one, one_s, one_l), (dp2, dp2_s, dp2_l) = runs["one"], runs["dp2"]
    by_rank["itc_dp2"] = [r["launches"] for r in dp2]
    check(set(one_l) == set(dp2_l) and len(one_l) > 0,
          "the dp=2 driver ran other epochs than one rank")
    worst = max(abs(dp2_l[k][0] - v[0]) / abs(v[0]) for k, v in one_l.items())
    mrr = {v: (one[0]["results"][v], dp2[0]["results"][v])
           for v in one[0]["results"]}
    per_epoch = {}
    for label, recs in (("one", one_l), ("dp2", dp2_l)):
        for (stream, ep), (_, s) in recs.items():
            if ep > 1:
                per_epoch.setdefault(stream, {}).setdefault(label, []).append(s)
    per_epoch = {s: {k: float(np.mean(v)) for k, v in x.items()}
                 for s, x in per_epoch.items()}
    log(f"[mesh] (b) ITC driver through cli.main, {n} entities per KG, "
        f"d={dim}, batch {batch}, {epochs} epochs: 1 rank {one[0]['seconds']:.1f}"
        f" s, dp=2 over {dp2[0]['transport']} {[round(r['seconds'], 1) for r in dp2]}"
        f" s per rank; worst relative loss difference over "
        f"{len(one_l)} stream epochs {worst:.3e}; test MRR (1 rank, dp=2) "
        f"{mrr}; seconds per stream epoch (mean of epochs 2-{epochs}) "
        f"{per_epoch}; staged collectives per rank "
        f"{[r['staged'] for r in dp2]}; launches per rank {by_rank['itc_dp2']}")
    check(worst <= 2e-3, "the dp=2 driver's losses differ from one rank's "
          "beyond rtol 2e-3")
    check(all(abs(a - b) < 0.02 for a, b in mrr.values()),
          f"the dp=2 driver's test MRRs are not within 0.02: {mrr}")
    numbers["itc_dp2"] = dict(seconds_one=one[0]["seconds"],
                              seconds_dp2=[r["seconds"] for r in dp2],
                              worst_rel_loss_diff=worst, test_mrr=mrr,
                              seconds_per_stream_epoch=per_epoch,
                              launches_one_rank=one[0]["launches"])

    # K1 and K2 on every rank of every run
    expect = {"world1": ("fused_row_adagrad", "rank_count", "conv_score"),
              "dryrun_2x2": ("fused_row_adagrad", "rank_count"),
              "ring_2": ("rank_count",),
              "itc_dp2": ("fused_row_adagrad", "rank_count", "conv_score")}
    for run, names in expect.items():
        for r, counts in enumerate(by_rank[run]):
            for name in names:
                check(counts[name] > 0, f"{name} did not launch on rank {r} "
                      f"of the mesh run {run}: {by_rank[run]}")
    total = {name: sum(c[name] for runs_ in by_rank.values() for c in runs_)
             for name in _kernel_modules()}
    numbers["launches_by_rank"] = by_rank
    log(f"[mesh] {json.dumps(numbers)}")
    return total, by_rank, numbers


# Phase 9's width, and floors of its test MRRs. The JAX package and the
# port on the CPU (tests/wide_itc_reference.py) give nv 0.897, rv 0.989
# and final 0.181 at this width; av is near chance (about 0.009, against
# 0.005 for random ranks) there and at d = 75 too, since three epochs
# barely train the attribute view, so it has no floor.
WIDE_DIM = 384
WIDE_FLOORS = {"nv": 0.85, "rv": 0.9, "final": 0.12}


def phase_wide_itc(dev, n=5_000, dim=WIDE_DIM, batch=5000, epochs=3):
    """Phase 9 (see the module's docstring). Returns the kernels' launches
    and the numbers."""
    import numpy as np
    import torch

    from multike_tpu_torch import cli
    from multike_tpu_torch.data.readers import read_links
    from multike_tpu_torch.kernels import rank_kernel as rk
    from multike_tpu_torch.params import l2_normalize

    cfg = driver_config(n, "itc_wide", 75, batch, epochs)
    args, metrics = cli_files(cfg, os.path.join(REPO, "output", "chip_smoke",
                                                "itc_wide"))
    _zero_launches()
    t0 = time.time()
    results = cli.main(["-m", "ITC", "-d", cfg.training_data, "--args", args,
                        "--set", f"dim={dim}",
                        "--set", f"metrics_log_path={metrics}"])
    run_s = time.time() - t0
    launches = _launches()
    recs = _stream_losses(metrics)
    log(f"[wide] ITC through cli.main at --set dim={dim}, {n} entities per "
        f"KG, {epochs} epochs in {run_s:.1f} s (DataModel included); test "
        f"MRR {results}; launches {launches}")
    check(all(v > 0 for k, v in launches.items() if k != "per_slot_loss")
          and launches["per_slot_loss"] == 0,
          f"a kernel did not launch at d={dim}, or K5 (no per-slot draws "
          f"in the ITC driver) did: {launches}")
    check({s for s, _ in recs} >= set(ITC_STREAMS)
          and all(np.isfinite(v[0]) for v in recs.values()),
          "a stream did not run, or its loss is not finite")
    check(set(results) == {"nv", "rv", "av", "final"}
          and all(np.isfinite(v) for v in results.values())
          and all(results[k] >= v for k, v in WIDE_FLOORS.items()),
          f"test MRRs {results} below the floors {WIDE_FLOORS}")

    # the saved final embeddings of the test pairs, ranked once more
    runs = sorted(glob.glob(os.path.join(cfg.output, "MultiKE_ITC", "*", "*")))
    check(runs, "the embeddings were not saved")
    ent = np.load(os.path.join(runs[-1], "ent_embeds.npy"))
    check(ent.shape[1] == dim, f"saved embeddings of width {ent.shape[1]}")
    ids = []
    for kg in (1, 2):
        with open(os.path.join(runs[-1], f"kg{kg}_ent_ids")) as f:
            ids.append(dict(ln.rstrip("\n").split("\t") for ln in f))
    links = read_links(cfg.training_data + cfg.dataset_division + "test_links")
    d1, d2 = (l2_normalize(torch.as_tensor(
        ent[[int(ids[s][p[s]]) for p in links]], device=dev), axis=1)
        for s in (0, 1))
    n1 = d1.shape[0]
    gold = torch.sum(d1 * d2, dim=1)
    gidx = torch.arange(n1, dtype=torch.int32, device=dev)
    geo = rk.plan(n1, n1, dim, device=dev)
    got = rk.rank_count(d1, gold, gidx, d2)
    want = rk.rank_count_plain(d1, gold, gidx, d2)
    c_mis, i_mis, ties = _rank_compare(d1, d2, gold, None, got, want)
    mrr = float((1.0 / (got[0].double() + 1)).mean())
    log(f"[wide] saved final test embeddings, {n1}x{n1} d={dim}, "
        f"{geo['path']} plan ({geo['ctas_per_sm']} CTAs per SM): K2 against "
        f"its plain version: count mismatches {c_mis}, argmax mismatches "
        f"{i_mis}, all on {ties} rows within 1e-6 of a tie; MRR {mrr:.6f} "
        f"against the driver's {results['final']:.6f}")
    check(geo["path"] == "streamed", f"d={dim} ran the {geo['path']} plan")
    check(abs(mrr - results["final"]) <= 5e-3,
          "the saved embeddings do not give the driver's final test MRR")
    return launches, dict(entities_per_kg=n, dim=dim, epochs=epochs,
                          run_s=run_s, test_mrr=results, launches=launches,
                          rerank=dict(rows=n1, plan=geo["path"],
                                      count_mismatches=c_mis,
                                      argmax_mismatches=i_mis, tie_rows=ties,
                                      mrr=mrr))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--mesh-rank":
        return mesh_rank(args[1], args[2])       # a rank of phase 8
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    if args and args not in (["--k3"], ["--k4"], ["--k5"]) and (
            len(args) != 2 or args[0] not in ("--k1-of", "--k2-of")):
        print("usage: chip_smoke.py [--k1-of DIR | --k2-of DIR | --k3 | "
              "--k4 | --k5]", file=sys.stderr)
        return 2
    root = os.path.abspath(args[1]) if len(args) == 2 else REPO
    if not os.path.isdir(os.path.join(root, "multike_tpu_torch")):
        print(f"chip_smoke: the multike_tpu_torch package is not in {root}",
              file=sys.stderr)
        return 2
    # the benchmark's yardsticks (peaks, bounds, inputs) from this script's
    # own repo, whichever package DIR holds
    from gpubench.lib.peaks import card_peaks, power_limit
    sys.path.insert(0, root)
    import multike_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)

    t_start = time.time()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = power_limit()
    peaks = card_peaks(card.split(",")[0].strip())
    log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"bounds from this part's published peaks: {peaks[0] / 1e12:.2f} "
        f"TB/s, {peaks[1] / 1e12:.0f} TFLOP/s fp32")

    built = phase_build()
    if args:                    # one kernel's phase: its line, the card's
        what, run = {
            "--k3": ("K3", lambda: {"kernels": [
                phase_chunk_loss(dev, peaks)]}),
            "--k4": ("K4", lambda: {"kernels": [
                phase_conv_score(dev, peaks)]}),
            "--k5": ("K5", lambda: {"kernels": [
                phase_slot_loss(dev, peaks, built)]}),
            "--k1-of": (f"K1 of {root}", lambda: {
                "k1_of": root, "steps": phase_k1_of(dev, peaks, root)}),
            "--k2-of": (f"K2 of {root}",
                        lambda: {"kernels": [phase_rank(dev, peaks)]}),
        }[args[0]]
        out = run()
        log(f"[done] {what} in {time.time() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        print(card, flush=True)
        return 0
    k1 = phase_apply(dev, peaks)
    k3 = phase_chunk_loss(dev, peaks)
    k4 = phase_conv_score(dev, peaks)
    k5 = phase_slot_loss(dev, peaks, built)
    k2 = phase_rank(dev, peaks)
    k2["widths"] = phase_widths(dev, peaks)
    main_launches = phase_main_path(dev)
    parity = phase_parity(dev)
    itc_launches, _, data = phase_itc(dev)
    ssl_launches, _ = phase_ssl(dev, data)
    mesh_launches, mesh_by_rank, _ = phase_mesh(dev, card)
    wide_launches, wide = phase_wide_itc(dev)

    for k in (k1, k2, k3, k4, k5):
        k["launches"] = ssl_launches[k["name"]]
        k["launches_by_path"] = {"ssl": ssl_launches[k["name"]],
                                 "itc": itc_launches[k["name"]],
                                 "rel_view": main_launches[k["name"]],
                                 "mesh": mesh_launches[k["name"]],
                                 f"itc_d{WIDE_DIM}": wide_launches[k["name"]]}
        k["mesh_launches_by_rank"] = {
            run: [c[k["name"]] for c in counts]
            for run, counts in mesh_by_rank.items()}
    log(f"[parity] {json.dumps(parity)}")
    log(f"[wide] {json.dumps(wide)}")
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
