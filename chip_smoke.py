#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``theanompi_tpu_torch``) on one
NVIDIA card, driven through the port's own entry points.

    python3 chip_smoke.py          # from the repository root; one card

Phases (each one fails the run, with a non-zero exit, if it fails):

1. Device: the card's name and power limit (nvidia-smi).  No card: exit.
2. Build: compile every kernel under ``theanompi_tpu_torch/csrc/`` with
   nvcc for sm_90a (one nvcc per source, in parallel); print each
   ``-Xptxas -v`` report and the build seconds.
3. Kernels against their plain PyTorch versions on the card, at the
   shapes one batch-32 ResNet-50 forward gives them: the fused BN
   epilogue K1a/K1b at every (rows, C) the forward launches (bf16) plus
   a ragged f32 case, tolerance 1 ulp (the kernel rounds after each op,
   as the plain version does, so it is expected to be bit-exact); the
   stem max-pool K2a at (32, 112, 112, 64) bf16 with NaNs and an
   all-(-inf) window, exact.  Device times from CUDA graphs of many
   launches, timed with CUDA events.
4. The slice: a full-width ResNet-50 (stages (3, 4, 6, 3), width 64,
   1000 classes, conv7 stem, bf16) with random weights from a seed,
   exported with ``export_model`` and served by ``InferenceServer`` on
   the card; a few dozen 1-4 row uint8 224x224 requests from several
   threads.  Checks: coalescing (``max_occupancy > 1``), the launch
   counts of the run (K1a = 37, K1b = 16, K2a = 1 per batch), and the
   answers of a subset of rows against the same weights in f32 through
   the plain versions on the CPU (per-row relative L2 error <= 0.05 and
   top-1 agreement on >= 90% of rows: bf16 keeps 8 bits of mantissa
   through 53 layers).
   Then one batch-32 ``InferenceSession.infer`` is timed on the host
   clock and traced with ``torch.profiler`` (device time by kernel
   family; device idle share against the unprofiled host time).
5. Result lines: a ``{"kernels": [...]}`` JSON line, the card line, and
   last ``{"ok": true, "device": {...}}``.

Full results (per-shape kernel times, the trace) go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # same sheet: f32 outside the tensor cores
BATCH = 32
CHECK_ROWS = 16
KERNEL_SOURCES = {
    "scale_bias_act": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                       "theanompi_tpu/ops/fused_bn.py:138"),
    "scale_bias_act_res": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                           "theanompi_tpu/ops/fused_bn.py:182"),
    "maxpool3x3s2": ("theanompi_tpu_torch/csrc/maxpool.cu",
                     "theanompi_tpu/ops/maxpool_pallas.py:153"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the one card the run uses."""
    out = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fns, reps: int) -> float:
    """Device ms per call of ``fns`` (round-robin), from one CUDA graph
    of ``reps`` rounds replayed three times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for f in fns:
                f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps * len(fns))
    del graph
    return ms


def bound_ms(nbytes: float, ops: float) -> float:
    """Least time the card could take: the larger of the bytes over the
    HBM rate and the f32 operations over the f32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def bound_by(nbytes: float, ops: float) -> str:
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations")


def copies_for(nbytes: int) -> int:
    """Distinct buffers to cycle so the working set exceeds the 50 MB L2
    (the main path finds a BN input written by the conv before it)."""
    return max(1, min(16, math.ceil(128e6 / max(nbytes, 1))))


def ulp_distance(torch, a, b) -> int:
    """Largest distance in units of last place between two float
    tensors of one dtype (sign-magnitude bits mapped to ordered ints)."""
    itype, mask = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
                   else (torch.int32, 0x7FFFFFFF))
    ia, ib = (t.contiguous().view(itype).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & mask), ia)
    ib = torch.where(ib < 0, -(ib & mask), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


# -- phase 3: kernels against their plain versions --------------------------

def k1_cases(torch, module, x):
    """(rows, C, residual?, act) -> launches per forward, recorded with
    forward hooks on every BatchNormAct of one forward."""
    from theanompi_tpu_torch.models.layers import BatchNormAct

    cases: dict[tuple, int] = {}

    def hook(mod, args, kwargs, out):
        rows = args[0].numel() // args[0].shape[-1]
        key = (rows, args[0].shape[-1],
               kwargs.get("residual") is not None, mod.act)
        cases[key] = cases.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in module.modules() if isinstance(m, BatchNormAct)]
    with torch.inference_mode():
        module(x)
    for h in hooks:
        h.remove()
    return cases


def check_k1(torch, cases) -> dict:
    from theanompi_tpu_torch.ops import fused_bn

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_out, worst = [], {"scale_bias_act": 0.0, "scale_bias_act_res": 0.0}
    # per forward: kernel ms, plain ms, bytes, operations
    fwd = {"scale_bias_act": [0.0, 0.0, 0.0, 0.0],
           "scale_bias_act_res": [0.0, 0.0, 0.0, 0.0]}
    all_cases = [(k, n, torch.bfloat16) for k, n in sorted(cases.items())]
    all_cases.append(((1000 * 3 + 7, 64, True, "relu"), 0, torch.float32))
    for (rows, c, has_res, act), per_fwd, dtype in all_cases:
        name = "scale_bias_act_res" if has_res else "scale_bias_act"
        elt = torch.tensor([], dtype=dtype).element_size()
        nbytes = rows * c * elt * (3 if has_res else 2) + 2 * c * 4
        n = copies_for(nbytes)
        xs = [torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
              for _ in range(n)]
        rs = [torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
              if has_res else None for _ in range(n)]
        s = torch.rand(c, generator=gen, device="cuda") + 0.5
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        y = fused_bn.scale_bias_act(xs[0], s, b, rs[0], act, dtype)
        ref = fused_bn.scale_bias_act_plain(xs[0], s, b, rs[0], act, dtype)
        torch.cuda.synchronize()
        ulp = ulp_distance(torch, y, ref)
        err = float((y.float() - ref.float()).abs().max().item())
        if ulp > 1:
            raise AssertionError(f"K1 {name} ({rows}, {c}) {dtype}: kernel "
                                 f"is {ulp} ulp from its plain version")
        worst[name] = max(worst[name], err)
        k_ms = graph_ms(torch, [
            (lambda i=i: fused_bn.scale_bias_act(xs[i], s, b, rs[i], act,
                                                 dtype)) for i in range(n)],
            reps=max(2, 40 // n))
        p_ms = graph_ms(torch, [
            (lambda i=i: fused_bn.scale_bias_act_plain(xs[i], s, b, rs[i],
                                                       act, dtype))
            for i in range(n)], reps=max(2, 20 // n))
        # mul + add (+ add) (+ compare) per element
        ops = rows * c * (2 + has_res + (act == "relu"))
        bound = bound_ms(nbytes, ops)
        for i, v in enumerate((k_ms, p_ms, nbytes, ops)):
            fwd[name][i] += per_fwd * v
        rows_out.append({"kernel": name, "rows": rows, "C": c,
                         "dtype": str(dtype).replace("torch.", ""),
                         "act": act, "per_forward": per_fwd, "ulp": ulp,
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound})
        log(f"  K1 {name:18s} rows={rows:7d} C={c:5d} "
            f"{str(dtype)[6:]:8s} act={act!s:5s} x{per_fwd:2d}/fwd "
            f"ulp={ulp} kernel {k_ms * 1e3:8.2f} us  plain "
            f"{p_ms * 1e3:8.2f} us  bound {bound * 1e3:8.2f} us")
        del xs, rs
    per_forward = {
        name: {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms(nb, ops),
               "bound_by": bound_by(nb, ops)}
        for name, (k_ms, p_ms, nb, ops) in fwd.items()}
    return {"cases": rows_out, "max_abs_err": worst,
            "per_forward": per_forward}


def check_k2(torch) -> dict:
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import maxpool

    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (BATCH, 112, 112, 64)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    bad = x.clone()
    bad[0, 0:2, 0:2, :] = float("-inf")       # all-(-inf) window at (0, 0)
    bad[1, 5, 7, :8] = float("nan")
    bad[3, 50:52, 60, 3] = float("nan")
    errs = []
    for t in (x, bad):
        y = maxpool.maxpool3x3s2(t)
        ref = maxpool.maxpool3x3s2_plain(t)
        torch.cuda.synchronize()
        same_nan = bool(torch.equal(torch.isnan(y), torch.isnan(ref)))
        fin = ~torch.isnan(ref)
        if not same_nan or not torch.equal(y[fin], ref[fin]):
            raise AssertionError("K2 maxpool3x3s2 differs from its plain "
                                 "version")
        errs.append(float((y[fin].float() - ref[fin].float()).abs().max()))
    if not bool(torch.isneginf(maxpool.maxpool3x3s2(bad)[0, 0, 0]).all()):
        raise AssertionError("K2: all-(-inf) window did not give -inf")
    nbytes = x.numel() * 2 + x.numel() // 4 * 2
    n = copies_for(nbytes)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(n)]
    k_ms = graph_ms(torch, [(lambda i=i: maxpool.maxpool3x3s2(xs[i]))
                            for i in range(n)], reps=max(2, 40 // n))
    p_ms = graph_ms(torch, [(lambda i=i: maxpool.maxpool3x3s2_plain(xs[i]))
                            for i in range(n)], reps=max(2, 20 // n))
    lib_ms = graph_ms(torch, [
        (lambda i=i: F.max_pool2d(xs[i].permute(0, 3, 1, 2), 3, 2, 1))
        for i in range(n)], reps=max(2, 40 // n))
    ops = 9 * x.numel() // 4                      # 9 compares per output
    bound = bound_ms(nbytes, ops)
    log(f"  K2 maxpool3x3s2 {shape} bf16 exact (NaN, -inf windows) kernel "
        f"{k_ms * 1e3:.2f} us  plain {p_ms * 1e3:.2f} us  F.max_pool2d "
        f"{lib_ms * 1e3:.2f} us  bound {bound * 1e3:.2f} us")
    return {"max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": bound_by(nbytes, ops)}


# -- phase 4: the served slice ----------------------------------------------

def seeded_weights(torch, ref_model, seed: int) -> None:
    """Random weights a bf16 comparison can read: every BN scale nonzero
    (exit BNs in [0.2, 0.5], the rest in [0.5, 1.5], so K1b's x*scale
    term is live), biases N(0, 0.1), and running mean/var set to the
    batch statistics of seeded calibration images, so activations stay
    O(1) through the depth.  Runs on the f32 CPU reference model."""
    from theanompi_tpu_torch.models.layers import BatchNormAct

    rng = np.random.default_rng(seed)
    module = ref_model.module
    exits = {id(blk.bn2) for blk in module.blocks}
    bns = [m for m in module.modules() if isinstance(m, BatchNormAct)]

    def calibrate(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean((0, 1, 2)))
        mod.var.copy_(x.var((0, 1, 2), unbiased=False))

    with torch.no_grad():
        for m in bns:
            c = m.scale.numel()
            lo, hi = (0.2, 0.5) if id(m) in exits else (0.5, 1.5)
            m.scale.copy_(torch.from_numpy(
                rng.uniform(lo, hi, c).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(c)).astype(np.float32)))
        hooks = [m.register_forward_pre_hook(calibrate) for m in bns]
        cal = rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        module(ref_model.data.device_transform(torch.from_numpy(cal)))
        for h in hooks:
            h.remove()


def serve(torch, model, ref_model, export_dir: str) -> dict:
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.serving import (
        BatchPolicy,
        InferenceServer,
        export_model,
    )

    export_model(model, export_dir, version=0)
    t0 = time.monotonic()
    server = InferenceServer(
        export_dir, replicas=1, device="cuda", reload_poll_s=0,
        policy=BatchPolicy(max_batch=BATCH, max_delay_ms=5.0,
                           max_queue=256))

    rng = np.random.default_rng(3)
    n_threads, per_thread = 12, 8
    reqs = [[rng.integers(0, 256, (int(rng.integers(1, 5)), 224, 224, 3),
                          dtype=np.uint8) for _ in range(per_thread)]
            for _ in range(n_threads)]
    answers = [[None] * per_thread for _ in range(n_threads)]
    lat_ms = []
    errors = []
    lock = threading.Lock()

    def client(i):
        try:
            for j, x in enumerate(reqs[i]):
                t = time.monotonic()
                answers[i][j] = server.submit(x)
                with lock:
                    lat_ms.append((time.monotonic() - t) * 1e3)
        except Exception as e:  # reported and failed below
            errors.append(e)

    server.start()
    log(f"  server up (export load + warmup of buckets "
        f"{server.policy.resolved_buckets()}) in "
        f"{time.monotonic() - t0:.1f} s")
    try:
        threads = [threading.Thread(target=client, args=(i,),
                                    name=f"smoke-client-{i}")
                   for i in range(n_threads)]
        _kernels.reset_launch_counts()
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        launches = _kernels.launch_counts()
        stats = server.stats()
    finally:
        server.stop()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed: {errors[:3]}")
    n_req = n_threads * per_thread
    rows = sum(x.shape[0] for r in reqs for x in r)
    batches = stats["batches"]
    log(f"  {n_req} requests ({rows} rows) from {n_threads} threads in "
        f"{batches} batches, max_occupancy {stats['max_occupancy']}; "
        f"launches {launches}")
    if stats["max_occupancy"] <= 1:
        raise AssertionError("no coalescing: max_occupancy <= 1")
    want = {"scale_bias_act": 37 * batches, "scale_bias_act_res": 16 * batches,
            "maxpool3x3s2": batches}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} for "
                             f"{batches} batches")

    # answers of a subset of rows against the f32 CPU reference
    got, xs = [], []
    for i in range(n_threads):
        for j in range(per_thread):
            if sum(x.shape[0] for x in xs) >= CHECK_ROWS:
                break
            xs.append(reqs[i][j])
            got.append(answers[i][j])
    x = np.concatenate(xs)
    got = np.concatenate(got)
    with torch.inference_mode():
        xt = ref_model.data.device_transform(torch.from_numpy(x))
        want_logits = ref_model.module(xt).numpy()
    if got.shape != want_logits.shape or not np.isfinite(got).all():
        raise AssertionError(f"served logits {got.shape} not finite or "
                             f"not {want_logits.shape}")
    rel = (np.linalg.norm(got - want_logits, axis=1)
           / np.linalg.norm(want_logits, axis=1))
    top1 = float((got.argmax(1) == want_logits.argmax(1)).mean())
    log(f"  {len(x)} rows vs f32 CPU reference: max rel L2 "
        f"{rel.max():.4g}, top-1 agreement {top1:.3f}")
    if rel.max() > 0.05 or top1 < 0.9:
        raise AssertionError(f"served answers off the f32 reference: rel "
                             f"L2 {rel.max():.4g} (<= 0.05), top-1 {top1} "
                             "(>= 0.9)")
    lat = np.sort(np.asarray(lat_ms))
    return {"requests": n_req, "rows": rows, "batches": batches,
            "max_occupancy": stats["max_occupancy"], "launches": launches,
            "wall_s": wall, "requests_per_s": n_req / wall,
            "rows_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_rel_l2": float(rel.max()), "top1_agreement": top1,
            "checked_rows": int(len(x))}


def trace_forward(torch, export_dir: str) -> dict:
    """Where one batch-32 ``InferenceSession.infer`` spends its time:
    host-clock ms per call (H2D of the uint8 rows, eval transform,
    forward, D2H of the logits), and from ``torch.profiler`` the device
    time by kernel family.  The idle share is 1 - device ms / host ms of
    the unprofiled calls: the profiler's own host work lengthens the
    profiled calls, so their wall is reported beside it, not used."""
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.serving import InferenceSession

    session = InferenceSession.from_export(export_dir, device="cuda")
    x = np.random.default_rng(5).integers(0, 256, (BATCH, 224, 224, 3),
                                          dtype=np.uint8)
    for _ in range(3):
        session.infer(x)
    reps = 20
    t0 = time.monotonic()
    for _ in range(reps):
        session.infer(x)
    infer_ms = (time.monotonic() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(5):
            session.infer(x)
        wall_us = (time.monotonic() - t0) * 1e6
    families = {"fused_bn (K1)": 0.0, "maxpool (K2)": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = ("fused_bn (K1)" if "scale_bias_act_kernel" in e.name else
               "maxpool (K2)" if "maxpool3x3s2_kernel" in e.name else
               "other")
        families[fam] += us
    device_us = sum(families.values())
    device_ms = device_us / 5e3
    out = {"infer_ms": infer_ms, "images_per_s": BATCH * 1e3 / infer_ms,
           "profiled_infer_ms": wall_us / 5e3,
           "device_ms_per_infer": device_ms,
           "idle_share": (1 - device_ms / infer_ms) if device_us else None,
           "families_ms_per_infer": {k: v / 5e3
                                     for k, v in families.items()},
           "top_kernels_ms_per_infer": {
               k: v / 5e3 for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:12]}}
    if not device_us:
        log("  torch.profiler recorded no device time (not measured)")
    else:
        log(f"  device {device_ms:.3f} ms per infer; by family "
            + ", ".join(f"{k} {v:.3f} ms"
                        for k, v in out["families_ms_per_infer"].items()))
    log(f"  batch-{BATCH} infer {infer_ms:.2f} ms host clock "
        f"({out['images_per_s']:.0f} images/s), "
        f"{out['profiled_infer_ms']:.2f} ms under the profiler")
    if device_us:
        log(f"  idle share {out['idle_share']:.3f} "
            f"(1 - {device_ms:.3f} / {infer_ms:.2f} ms unprofiled)")
    return out


def main() -> int:
    # one card: the first in nvidia-smi's (PCI bus) order unless the
    # caller picks one
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: runs on one card; CUDA_VISIBLE_DEVICES="
              f"{os.environ['CUDA_VISIBLE_DEVICES']} shows "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.ops import _kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    log("phase 1: device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  {card}  (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{kind}, {torch.cuda.device_count()} visible)")

    log("phase 2: build")
    t0 = time.monotonic()
    built = _kernels.build()
    for name, info in built.items():
        log(f"  {name}: {info['path']} in {info['seconds']:.1f} s")
        for line in info["ptxas"].splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line
                                    or "Compiling" in line):
                log(f"    {line.strip()}")
    log(f"  build wall {time.monotonic() - t0:.1f} s")

    log("phase 3: kernels against their plain versions")
    model = ResNet50(device="cuda")
    ref_model = ResNet50(device="cpu", config=dataclasses.replace(
        model.config, compute_dtype="float32"))
    seeded_weights(torch, ref_model, seed=0)
    model.module.load_state_dict(ref_model.module.state_dict())
    x0 = torch.zeros((BATCH, 224, 224, 3), dtype=torch.uint8, device="cuda")
    cases = k1_cases(torch, model.module, model.data.device_transform(x0))
    if sum(cases.values()) != 53:
        raise AssertionError(f"expected 53 BN epilogues per forward, got "
                             f"{sum(cases.values())}")
    k1 = check_k1(torch, cases)
    k2 = check_k2(torch)

    log("phase 4: the served slice")
    with tempfile.TemporaryDirectory() as tmp:
        export_dir = os.path.join(tmp, "export")
        served = serve(torch, model, ref_model, export_dir)
        log(f"  {card}: {served['requests_per_s']:.1f} requests/s "
            f"({served['rows_per_s']:.1f} rows/s), latency p50 "
            f"{served['p50_ms']:.1f} ms p99 {served['p99_ms']:.1f} ms")
        log("phase 4b: where one batch-32 infer spends its time")
        traced = trace_forward(torch, export_dir)

    kernels = []
    for name in ("scale_bias_act", "scale_bias_act_res"):
        kernels.append({**k1["per_forward"][name], "library_ms": None,
                        "max_abs_err": k1["max_abs_err"][name],
                        "name": name})
    kernels.append({"ms": k2["ms"], "plain_ms": k2["plain_ms"],
                    "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
                    "library_ms": k2["library_ms"],
                    "max_abs_err": k2["max_abs_err"],
                    "name": "maxpool3x3s2"})
    for k in kernels:
        src, replaces = KERNEL_SOURCES[k["name"]]
        k.update(route="cuda", source=src, replaces=replaces,
                 launches=served["launches"][k["name"]])
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "k1_cases": k1["cases"],
                   "k2": k2, "served": served, "trace": traced,
                   "kernels": kernels,
                   "note": "kernel ms/plain_ms/bound_ms of the fused BN "
                           "epilogue are per batch-32 forward (sum over "
                           "its launches); max-pool per launch"}, f,
                  indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
