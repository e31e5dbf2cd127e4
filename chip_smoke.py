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
5. The training kernels against their plain versions on the card, at
   the shapes one batch-128 ResNet-50 training step gives them: the BN
   epilogue backward K1c/K1d at every (rows, C) of the step (bf16) plus
   a ragged f32 case, dx and dres bit-exact and ds/db per channel
   within 1e-5 of the sum of |g*x| (|g|) (the kernel and the plain
   version sum in different orders); the argmax pool K2b and the
   gather backward K2c at (128, 112, 112, 64) bf16 with ties, NaNs and
   an all-(-inf) window, exact.  Times as in phase 3, beside each
   kernel's byte bound, its plain version and, where one PyTorch call
   computes the same function, that call (never used by the port).
   The forward K1a/K1b are timed again at the batch-128 shapes.
6. The training slice.
   (a) Gradient check: seeded weights on a full-width bf16 ResNet-50 on
   the card, and in f32 and in bf16 on the CPU (plain versions), one
   BSP step each on the same 8 uint8 images with the same explicit crop
   offsets and flips.  At exit-BN scales 0.05-0.1: loss within relative
   1e-2 and the updated BN running statistics within relative L2 0.05
   of f32; relative L2 error of the flattened gradient <= 0.1 against
   f32 and against the CPU's bf16 step (bf16 itself is about 0.05 from
   f32 there; see ``grad_check``).  Phase 4's weights are measured too.
   (b) ``run_bsp_session`` on a one-rank NCCL process group: ResNet-50
   at batch 128, bf16, synthetic ImageNet (pool 64, store 256,
   on-device augment), 24 steps in one epoch and a 2-batch validation.
   Checks: launches per training step exactly K1a 37, K1b 16, K1c 37,
   K1d 16, K2b 1, K2c 1, K2a 0, and K2a once per validation batch;
   every loss finite.  Prints images/s and ms per step and the
   gradient copies the K1 backward made.
   (c) One training step on a staged batch, timed (the device-step
   leg) and traced with ``torch.profiler``: device time by family and
   the idle share against the unprofiled step.
7. Result lines: a ``{"kernels": [...]}`` JSON line, the card line, and
   last ``{"ok": true, "device": {...}}``.

Full results (per-shape kernel times, the traces) go to
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
TRAIN_BATCH = 128
TRAIN_STEPS = 24
CHECK_ROWS = 16
GRAD_CHECK_IMAGES = 8
#: exit-BN scale ranges of the seeded weights: phase 4's, and phase 6a's
#: (see grad_check for why the gradient check needs smaller ones)
SERVE_EXIT_SCALES = (0.2, 0.5)
GRAD_CHECK_EXIT_SCALES = (0.05, 0.1)
#: phase 6a limits: relative error of the loss and of the updated BN
#: running statistics against f32, and relative L2 error of the whole
#: flattened gradient against f32 and against bf16 on the CPU
GRAD_CHECK_LIMITS = {"loss_rel": 1e-2, "stats": 0.05, "grad_vs_f32": 0.1,
                     "grad_vs_cpu_bf16": 0.1}
KERNEL_SOURCES = {
    "scale_bias_act": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                       "theanompi_tpu/ops/fused_bn.py:138"),
    "scale_bias_act_res": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                           "theanompi_tpu/ops/fused_bn.py:182"),
    "scale_bias_act_bwd": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                           "theanompi_tpu/ops/fused_bn.py:154"),
    "scale_bias_act_res_bwd": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                               "theanompi_tpu/ops/fused_bn.py:199"),
    "maxpool3x3s2": ("theanompi_tpu_torch/csrc/maxpool.cu",
                     "theanompi_tpu/ops/maxpool_pallas.py:153"),
    "maxpool3x3s2_argmax": ("theanompi_tpu_torch/csrc/maxpool.cu",
                            "theanompi_tpu/ops/maxpool_pallas.py:169"),
    "maxpool3x3s2_bwd": ("theanompi_tpu_torch/csrc/maxpool.cu",
                         "theanompi_tpu/ops/maxpool_pallas.py:195"),
}
#: launches of each training kernel per batch-128 step
TRAIN_LAUNCHES = {"scale_bias_act": 37, "scale_bias_act_res": 16,
                  "scale_bias_act_bwd": 37, "scale_bias_act_res_bwd": 16,
                  "maxpool3x3s2_argmax": 1, "maxpool3x3s2_bwd": 1,
                  "maxpool3x3s2": 0}


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


# -- phase 5: the training kernels against their plain versions -------------

def check_k1_bwd(torch, cases) -> dict:
    """K1c/K1d at every (rows, C) of a batch-128 step (bf16) and a ragged
    f32 case: dx/dres 0 ulp, ds/db within 1e-5 of sum|g*x| / sum|g|."""
    from theanompi_tpu_torch.ops import fused_bn

    gen = torch.Generator(device="cuda").manual_seed(4)
    names = {False: "scale_bias_act_bwd", True: "scale_bias_act_res_bwd"}
    rows_out = []
    worst = {n: 0.0 for n in names.values()}
    step = {n: [0.0, 0.0, 0.0, 0.0] for n in names.values()}
    all_cases = [(k, n, torch.bfloat16) for k, n in sorted(cases.items())]
    all_cases.append(((1000 * 3 + 7, 64, True, "relu"), 0, torch.float32))
    for (rows, c, has_res, act), per_step, dtype in all_cases:
        name = names[has_res]
        relu = act == "relu"
        elt = torch.tensor([], dtype=dtype).element_size()
        # x, g read and dx written (+ res read and dres written)
        nbytes = rows * c * elt * (5 if has_res else 3) + 4 * c * 4
        n = copies_for(nbytes)

        def rand():
            return torch.randn(rows, c, generator=gen,
                               device="cuda").to(dtype)

        xs = [rand() for _ in range(n)]
        gs = [rand() for _ in range(n)]
        rs = [rand() if has_res else None for _ in range(n)]
        s = torch.rand(c, generator=gen, device="cuda") + 0.5
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        got = fused_bn.scale_bias_act_bwd(xs[0], s, b, gs[0], rs[0], relu)
        want = fused_bn._bwd_plain(xs[0], s, b, rs[0], gs[0], relu)
        torch.cuda.synchronize()
        ulp = ulp_distance(torch, got[0], want[0])
        if has_res:
            ulp = max(ulp, ulp_distance(torch, got[1], want[1]))
        gm = gs[0].float()
        if relu:
            z = xs[0].float() * s + b + (rs[0].float() if has_res else 0)
            gm = torch.where(z > 0, gm, 0)
        ds_err = (got[2] - want[2]).abs()
        db_err = (got[3] - want[3]).abs()
        ds_rel = float((ds_err / (gm * xs[0].float()).abs().sum(0)
                        .clamp_min(1e-30)).max())
        db_rel = float((db_err / gm.abs().sum(0).clamp_min(1e-30)).max())
        if ulp or ds_rel > 1e-5 or db_rel > 1e-5:
            raise AssertionError(
                f"K1 {name} ({rows}, {c}) {dtype}: dx/dres {ulp} ulp, "
                f"ds {ds_rel:.3g} and db {db_rel:.3g} of their magnitude "
                "sums (limits 0, 1e-5, 1e-5)")
        worst[name] = max(worst[name], float(ds_err.max()),
                          float(db_err.max()))
        k_ms = graph_ms(torch, [
            (lambda i=i: fused_bn.scale_bias_act_bwd(xs[i], s, b, gs[i],
                                                     rs[i], relu))
            for i in range(n)], reps=max(2, 40 // n))
        p_ms = graph_ms(torch, [
            (lambda i=i: fused_bn._bwd_plain(xs[i], s, b, rs[i], gs[i],
                                             relu))
            for i in range(n)], reps=max(2, 10 // n))
        # mask: mul, add (, add), compare; g*s; g*x and two sums
        ops = rows * c * (4 + has_res + 3)
        bound = bound_ms(nbytes, ops)
        for i, v in enumerate((k_ms, p_ms, nbytes, ops)):
            step[name][i] += per_step * v
        rows_out.append({"kernel": name, "rows": rows, "C": c,
                         "dtype": str(dtype).replace("torch.", ""),
                         "act": act, "per_step": per_step, "ulp": ulp,
                         "ds_rel": ds_rel, "db_rel": db_rel, "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": bound})
        log(f"  K1 {name:22s} rows={rows:7d} C={c:5d} "
            f"{str(dtype)[6:]:8s} act={act!s:5s} x{per_step:2d}/step "
            f"ulp={ulp} ds {ds_rel:.1e} db {db_rel:.1e} kernel "
            f"{k_ms * 1e3:8.2f} us  plain {p_ms * 1e3:8.2f} us  bound "
            f"{bound * 1e3:8.2f} us")
        del xs, gs, rs, got, want
    per_step_out = {
        name: {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms(nb, ops),
               "bound_by": bound_by(nb, ops)}
        for name, (k_ms, p_ms, nb, ops) in step.items()}
    return {"cases": rows_out, "max_abs_err": worst,
            "per_step": per_step_out}


def check_k2_train(torch) -> dict:
    """K2b and K2c at (128, 112, 112, 64) bf16 with ties, NaNs and an
    all-(-inf) window: y, idx and dx exact."""
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import maxpool

    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (TRAIN_BATCH, 112, 112, 64)

    def rand(shp):
        return torch.randn(shp, generator=gen, device="cuda").to(
            torch.bfloat16)

    x = rand(shape)
    x[0, 0:2, 0:2, :] = float("-inf")       # all-(-inf) window at (0, 0)
    x[1, 5, 7, :8] = float("nan")
    x[1, 6, 7, :8] = float("nan")           # same window, later tap
    x[3, 40:43, 40:43, :] = 0.5             # ties
    y, idx = maxpool.maxpool3x3s2_argmax(x)
    want_y, want_idx = maxpool.maxpool3x3s2_argmax_plain(x)
    g = rand(y.shape)
    dx = maxpool.maxpool3x3s2_bwd(g, idx)
    want_dx = maxpool.maxpool3x3s2_bwd_plain(g, want_idx)
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(y), torch.isnan(want_y)))
    fin = ~torch.isnan(want_y)
    if not (same_nan and torch.equal(y[fin], want_y[fin])
            and torch.equal(idx, want_idx) and torch.equal(dx, want_dx)):
        raise AssertionError("K2b/K2c differ from their plain versions")
    if not bool((idx[0, 0, 0] == 4).all()):
        raise AssertionError("K2b: all-(-inf) window's tap is not 4")
    del x, y, idx, g, dx, want_y, want_idx, want_dx
    # bytes: x read, y and the int8 idx written (K2b); g and idx read,
    # dx written (K2c)
    n_in = math.prod(shape)
    n_out = n_in // 4
    nbytes = n_in * 2 + n_out * 3
    n = copies_for(nbytes)
    xs = [rand(shape) for _ in range(n)]
    outs = [maxpool.maxpool3x3s2_argmax(t) for t in xs]
    gs = [rand(outs[0][0].shape) for _ in range(n)]
    fwd = {"ms": graph_ms(torch, [
        (lambda i=i: maxpool.maxpool3x3s2_argmax(xs[i])) for i in range(n)],
        reps=max(2, 40 // n)),
        "plain_ms": graph_ms(torch, [
            (lambda i=i: maxpool.maxpool3x3s2_argmax_plain(xs[i]))
            for i in range(n)], reps=max(2, 10 // n)),
        "library_ms": graph_ms(torch, [
            (lambda i=i: F.max_pool2d(xs[i].permute(0, 3, 1, 2), 3, 2, 1,
                                      return_indices=True))
            for i in range(n)], reps=max(2, 40 // n))}
    lib_idx = [F.max_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1,
                            return_indices=True)[1] for t in xs]
    bwd = {"ms": graph_ms(torch, [
        (lambda i=i: maxpool.maxpool3x3s2_bwd(gs[i], outs[i][1]))
        for i in range(n)], reps=max(2, 40 // n)),
        "plain_ms": graph_ms(torch, [
            (lambda i=i: maxpool.maxpool3x3s2_bwd_plain(gs[i], outs[i][1]))
            for i in range(n)], reps=max(2, 10 // n)),
        "library_ms": graph_ms(torch, [
            (lambda i=i: torch.ops.aten.max_pool2d_with_indices_backward(
                gs[i].permute(0, 3, 1, 2), xs[i].permute(0, 3, 1, 2),
                [3, 3], [2, 2], [1, 1], [1, 1], False, lib_idx[i]))
            for i in range(n)], reps=max(2, 40 // n))}
    for d, ops in ((fwd, 9 * n_out), (bwd, 4 * n_in)):
        d.update(bound_ms=bound_ms(nbytes, ops), bound_by=bound_by(nbytes,
                                                                   ops),
                 max_abs_err=0.0)
    log(f"  K2b argmax {shape} bf16 exact: kernel {fwd['ms'] * 1e3:.2f} us  "
        f"plain {fwd['plain_ms'] * 1e3:.2f} us  F.max_pool2d(indices) "
        f"{fwd['library_ms'] * 1e3:.2f} us  bound "
        f"{fwd['bound_ms'] * 1e3:.2f} us")
    log(f"  K2c gather bwd exact: kernel {bwd['ms'] * 1e3:.2f} us  plain "
        f"{bwd['plain_ms'] * 1e3:.2f} us  aten backward "
        f"{bwd['library_ms'] * 1e3:.2f} us  bound "
        f"{bwd['bound_ms'] * 1e3:.2f} us")
    return {"maxpool3x3s2_argmax": fwd, "maxpool3x3s2_bwd": bwd}


# -- phase 4: the served slice ----------------------------------------------

def seeded_weights(torch, ref_model, seed: int,
                   exit_scales: tuple[float, float] = SERVE_EXIT_SCALES
                   ) -> None:
    """Random weights a bf16 comparison can read: every BN scale nonzero
    (exit BNs uniform in ``exit_scales``, the rest in [0.5, 1.5], so
    K1b's x*scale term is live), biases N(0, 0.1), and running mean/var
    set to the batch statistics of seeded calibration images, so
    activations stay O(1) through the depth.  Runs on the f32 CPU
    reference model."""
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
            lo, hi = exit_scales if id(m) in exits else (0.5, 1.5)
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
    want = {k: 0 for k in launches}
    want.update(scale_bias_act=37 * batches, scale_bias_act_res=16 * batches,
                maxpool3x3s2=batches)
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


# -- phase 6: the training slice --------------------------------------------

def rel_l2(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def one_bsp_step(torch, model, batch, crops) -> dict:
    """One BSP step of ``model`` on uint8 ``batch`` with explicit crop
    offsets and flips; its loss, flattened gradient and updated running
    statistics (f32, on the CPU)."""
    from theanompi_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.ops.augment import crop_flip_normalize
    from theanompi_tpu_torch.parallel.bsp import (
        TrainState,
        make_bsp_train_step,
        running_stats,
    )
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    dev = model.device
    ys, xs, flips = (t.to(dev) for t in crops)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)

    def loss_fn(module, batch_, rng_):
        xb, yb = batch_
        logits = module(crop_flip_normalize(xb, ys, xs, flips, 224, mean,
                                            std), train=True)
        loss = L.softmax_cross_entropy(logits, yb)
        return loss, {"error": L.error_rate(logits.detach(), yb)}

    model.module.train()
    state = TrainState(model.module, build_optimizer(
        model.module.parameters(), 0.05, "sgd", momentum=0.9,
        weight_decay=1e-4))
    t0 = time.monotonic()
    metrics = make_bsp_train_step(loss_fn)(
        state, tuple(t.to(dev) for t in batch), None)
    out = {"loss": float(metrics["loss"]),
           "grads": torch.cat([p.grad.float().reshape(-1).cpu()
                               for p in model.module.parameters()]),
           "stats": torch.cat([b.float().reshape(-1).cpu()
                               for b in running_stats(model.module)]),
           "s": time.monotonic() - t0}
    model.module.eval()
    return out


def grad_check(torch) -> dict:
    """One BSP step of the same weights as a bf16 model on the card, an
    f32 model on the CPU and a bf16 model on the CPU (both through the
    plain versions), on the same 8 uint8 images, crops and flips.

    At phase 4's weights (exit-BN scales 0.2-0.5) the gradient of a
    batch-8 train-mode step is chaotic: a rounding anywhere moves it by
    tens of percent, so bf16 on the CPU is as far from f32 as the card
    is.  Those weights are measured and printed, not held to a limit.
    The check runs at exit scales 0.05-0.1 (every BN scale still
    nonzero), where bf16 itself is about 0.05 from f32 in relative L2
    (measured here in every run: ``cpu_bf16_vs_f32``), so the gradient
    limit is 0.1, the most the check allows, and the card is also held
    to the CPU's bf16 step."""
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    rng = np.random.default_rng(6)
    n = GRAD_CHECK_IMAGES
    batch = (torch.from_numpy(rng.integers(0, 256, (n, 256, 256, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 1000, n).astype(np.int64)))
    crops = (torch.from_numpy(rng.integers(0, 33, n)),
             torch.from_numpy(rng.integers(0, 33, n)),
             torch.from_numpy(rng.random(n) < 0.5))
    results = {}
    for label, exit_scales in (("serve_weights", SERVE_EXIT_SCALES),
                               ("check_weights", GRAD_CHECK_EXIT_SCALES)):
        f32 = ResNet50(device="cpu", config=dataclasses.replace(
            ResNet50.default_config(), compute_dtype="float32"))
        seeded_weights(torch, f32, seed=0, exit_scales=exit_scales)
        steps = {}
        for name, model in (("card", ResNet50(device="cuda")),
                            ("cpu_bf16", ResNet50(device="cpu")),
                            ("cpu_f32", f32)):
            if model is not f32:
                model.module.load_state_dict(f32.module.state_dict())
            steps[name] = one_bsp_step(torch, model, batch, crops)
        card, ref, bf = steps["card"], steps["cpu_f32"], steps["cpu_bf16"]
        r = {"exit_scales": list(exit_scales),
             "loss_card": card["loss"], "loss_cpu_f32": ref["loss"],
             "loss_rel": abs(card["loss"] - ref["loss"]) / abs(ref["loss"]),
             "grad_vs_f32": rel_l2(torch, card["grads"], ref["grads"]),
             "grad_vs_cpu_bf16": rel_l2(torch, card["grads"], bf["grads"]),
             "cpu_bf16_vs_f32": rel_l2(torch, bf["grads"], ref["grads"]),
             "stats": rel_l2(torch, card["stats"], ref["stats"]),
             "finite": bool(torch.isfinite(card["grads"]).all()),
             "cpu_f32_s": ref["s"], "cpu_bf16_s": bf["s"]}
        results[label] = r
        log(f"  exit-BN scales {exit_scales}: loss card {r['loss_card']:.6f} "
            f"cpu f32 {r['loss_cpu_f32']:.6f} (rel {r['loss_rel']:.3g}); "
            f"gradient rel L2 card vs f32 {r['grad_vs_f32']:.4g}, card vs "
            f"cpu bf16 {r['grad_vs_cpu_bf16']:.4g}, cpu bf16 vs f32 "
            f"{r['cpu_bf16_vs_f32']:.4g}; BN running stats rel L2 "
            f"{r['stats']:.4g} (cpu steps f32 {r['cpu_f32_s']:.1f} s, bf16 "
            f"{r['cpu_bf16_s']:.1f} s)")
    r = results["check_weights"]
    over = {k: r[k] for k, lim in GRAD_CHECK_LIMITS.items() if not r[k] <= lim}
    if over or not r["finite"]:
        raise AssertionError(
            f"card step off the CPU references at exit scales "
            f"{GRAD_CHECK_EXIT_SCALES}: {over} over {GRAD_CHECK_LIMITS}, "
            f"finite {r['finite']}")
    return {"images": n, "limits": GRAD_CHECK_LIMITS, **results}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_session(torch, workdir: str) -> tuple[dict, object]:
    """``run_bsp_session`` of a batch-128 ResNet-50 on a one-rank NCCL
    group; returns the results and the trained model."""
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.ops import _kernels, fused_bn
    from theanompi_tpu_torch.rules.bsp import run_bsp_session
    from theanompi_tpu_torch.utils.recorder import Recorder

    t0 = time.monotonic()
    data = ImageNet_data(seed=0, synthetic_n=TRAIN_STEPS * TRAIN_BATCH,
                         synthetic_pool=64, synthetic_store=256,
                         augment_on_device=True)
    config = dataclasses.replace(
        ResNet50.default_config(), batch_size=TRAIN_BATCH, n_epochs=1,
        print_freq=8, snapshot_dir=workdir)
    model = ResNet50(config=config, device="cuda", data=data)
    losses: list[float] = []
    flushes: list[tuple[int, float]] = []

    class LossRecorder(Recorder):
        def train_metrics(self, loss, error, n_images):
            losses.append(float(loss))
            super().train_metrics(loss, error, n_images)

    flush = model._flush_metrics

    def timed_flush(recorder):
        flush(recorder)
        flushes.append((len(losses), time.monotonic()))

    model._flush_metrics = timed_flush
    val_counts = {}
    val_epoch = model.val_epoch

    def counted_val_epoch(recorder):
        before = _kernels.launch_counts()
        out = val_epoch(recorder)
        after = _kernels.launch_counts()
        val_counts.update({k: after[k] - before[k] for k in after})
        return out

    model.val_epoch = counted_val_epoch
    recorder = LossRecorder(print_freq=config.print_freq)
    setup_s = time.monotonic() - t0
    _kernels.reset_launch_counts()
    fused_bn.grad_copies.reset()
    t0 = time.monotonic()
    result = run_bsp_session(model, recorder=recorder)
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    copies = fused_bn.grad_copies.value
    steps = len(losses)
    train_counts = {k: launches[k] - val_counts.get(k, 0) for k in launches}
    n_val = data.n_val // TRAIN_BATCH
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    log(f"  {steps} steps + {n_val} validation batches in {wall:.1f} s "
        f"(set-up {setup_s:.1f} s); train launches {train_counts}, "
        f"validation {val_counts}")
    if steps != TRAIN_STEPS or train_counts != want:
        raise AssertionError(f"train launches {train_counts} != {want} "
                             f"for {steps} steps")
    if (val_counts.get("maxpool3x3s2") != n_val
            or val_counts.get("scale_bias_act") != 37 * n_val):
        raise AssertionError(f"validation launches {val_counts} for {n_val} "
                             "batches")
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(
            result["val"]["loss"]):
        raise AssertionError(f"non-finite loss: {losses} {result['val']}")
    (n0, t_first), (n1, t_last) = flushes[0], flushes[-2]
    ms = (t_last - t_first) * 1e3 / (n1 - n0)
    out = {"steps": steps, "val_batches": n_val, "launches": launches,
           "train_launches": train_counts, "val_launches": val_counts,
           "grad_copies": copies, "losses": losses, "val": result["val"],
           "ms_per_step": ms, "images_per_s": TRAIN_BATCH * 1e3 / ms,
           "timed_steps": [n0, n1], "wall_s": wall, "setup_s": setup_s}
    log(f"  session steps {n0 + 1}-{n1}: {ms:.2f} ms/step, "
        f"{out['images_per_s']:.0f} images/s per card (loader overlapped); "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, val {result['val']}; "
        f"K1 backward gradient copies {copies}")
    return out, model


def family(name: str) -> str:
    """Kernel family of a device event name in a training step."""
    n = name.lower()
    if "scale_bias_act_bwd_kernel" in n or "sum_tiles_kernel" in n:
        return "K1 backward (K1c/K1d)"
    if "scale_bias_act_kernel" in n:
        return "K1 forward (K1a/K1b)"
    if "maxpool3x3s2" in n:
        return "max-pool (K2b/K2c)"
    if "nccl" in n:
        return "all-reduce (NCCL)"
    if ("sgd" in n or "multi_tensor" in n or "foreach" in n):
        return "optimizer"
    if "wgrad" in n or "dgrad" in n or "bprop" in n:
        return "convolutions, backward"
    if any(k in n for k in ("conv", "xmma", "cudnn", "implicit", "gemm",
                            "cutlass", "sm90", "nvjet")):
        return ("convolutions and GEMMs (forward, and backward kernels not "
                "named so)")
    if "reduce" in n:
        return "reductions (BN statistics, loss)"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "copies"
    return "other elementwise"


def trace_train_step(torch, model) -> dict:
    """The device-step leg: one training step on a staged batch, timed
    on the host clock (20 steps, synchronised) and traced (3 steps)."""
    from torch.profiler import ProfilerActivity, profile

    x, y = next(iter(model.data.train_batches(0, TRAIN_BATCH)))
    batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    gen = model._epoch_rng(0)

    def step():
        return model.train_step(model.state, batch, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 20
    t0 = time.monotonic()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / reps
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    families: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = family(e.name)
        families[fam] = families.get(fam, 0.0) + us
    device_ms = sum(families.values()) / 3e3
    out = {"step_ms": step_ms, "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
           "device_ms_per_step": device_ms,
           "idle_share": (1 - device_ms / step_ms) if device_ms else None,
           "peak_memory_gb": peak_gb,
           "families_ms_per_step": {k: v / 3e3 for k, v in sorted(
               families.items(), key=lambda kv: -kv[1])},
           "top_kernels_ms_per_step": {
               k: v / 3e3 for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:25]}}
    log(f"  device-step leg: {step_ms:.2f} ms/step on the host clock "
        f"({out['images_per_s']:.0f} images/s per card), peak memory "
        f"{peak_gb:.1f} GB")
    if not device_ms:
        log("  torch.profiler recorded no device time (not measured)")
    else:
        log(f"  device {device_ms:.2f} ms per step, idle share "
            f"{out['idle_share']:.3f}; by family " + ", ".join(
                f"{k} {v:.3f} ms"
                for k, v in out["families_ms_per_step"].items()))
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

    log("phase 5: the training kernels against their plain versions")
    x0 = torch.zeros((TRAIN_BATCH, 224, 224, 3), dtype=torch.uint8,
                     device="cuda")
    cases128 = k1_cases(torch, model.module, model.data.device_transform(x0))
    del x0
    k1_128 = check_k1(torch, cases128)
    k1_bwd = check_k1_bwd(torch, cases128)
    k2_train = check_k2_train(torch)
    del model
    torch.cuda.empty_cache()

    log("phase 6a: one step on the card against the CPU references")
    checked = grad_check(torch)

    import torch.distributed as dist

    log("phase 6b: run_bsp_session on a one-rank NCCL group")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            session, trained = train_session(torch, tmp)
        log("phase 6c: where one training step spends its time")
        step_trace = trace_train_step(torch, trained)
        del trained
    finally:
        dist.destroy_process_group()

    kernels = []
    for name in ("scale_bias_act", "scale_bias_act_res"):
        kernels.append({**k1["per_forward"][name], "library_ms": None,
                        "max_abs_err": k1["max_abs_err"][name],
                        "name": name, "launches_path": "serving",
                        "per_train_step": k1_128["per_forward"][name]})
    kernels.append({"ms": k2["ms"], "plain_ms": k2["plain_ms"],
                    "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
                    "library_ms": k2["library_ms"],
                    "max_abs_err": k2["max_abs_err"],
                    "name": "maxpool3x3s2", "launches_path": "serving"})
    for name in ("scale_bias_act_bwd", "scale_bias_act_res_bwd"):
        kernels.append({**k1_bwd["per_step"][name], "library_ms": None,
                        "max_abs_err": k1_bwd["max_abs_err"][name],
                        "name": name, "launches_path": "training"})
    for name in ("maxpool3x3s2_argmax", "maxpool3x3s2_bwd"):
        kernels.append({**k2_train[name], "name": name,
                        "launches_path": "training"})
    for k in kernels:
        src, replaces = KERNEL_SOURCES[k["name"]]
        runs = served if k["launches_path"] == "serving" else session
        k.update(route="cuda", source=src, replaces=replaces,
                 launches=runs["launches"][k["name"]],
                 train_launches_per_step=TRAIN_LAUNCHES[k["name"]],
                 train_session_launches=session["launches"][k["name"]])
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "k1_cases": k1["cases"],
                   "k2": k2, "served": served, "trace": traced,
                   "k1_cases_batch128": k1_128["cases"],
                   "k1_bwd_cases": k1_bwd["cases"], "k2_train": k2_train,
                   "grad_check": checked, "session": session,
                   "train_step_trace": step_trace, "kernels": kernels,
                   "note": "kernel ms/plain_ms/bound_ms of the fused BN "
                           "epilogue are per batch-32 forward (K1a/K1b; "
                           "per_train_step: per batch-128 step) or per "
                           "batch-128 step (K1c/K1d), summed over the "
                           "launches; max-pool per launch.  launches: "
                           "the served run (launches_path serving) or "
                           "the training session"}, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
