#!/usr/bin/env python3
"""Probe of the port's stem max-pool kernels (K2a value forward, K2b
argmax forward, K2c gather backward; ``theanompi_tpu_torch/csrc/
maxpool.cu``) on one NVIDIA card: registers, instruction counts and
device times of one or more versions of the source side by side.

    python3 tools/maxpool_kernel_probe.py                  # csrc/maxpool.cu
    python3 tools/maxpool_kernel_probe.py --source old=build/parent/maxpool.cu \\
        --source new=theanompi_tpu_torch/csrc/maxpool.cu --int32-index old

Each source is compiled with the port's nvcc flags into its own library
under ``build/probe/`` (one nvcc each, all started together).
``--int32-index NAME`` adds a copy of source NAME with every ``int64_t``
replaced by ``int32_t`` (right only for a source whose every index stays
below 2^31, as PR 2's does at the probe's shape; timed, never used by
the port): the time it saves is the share of the 64-bit index
arithmetic.  For each
library: each kernel's ``-Xptxas -v`` registers and spills, its SASS
(``cuobjdump -sass``, written with the results to ``--out``) instruction
count, and at ResNet-50's batch-128 stem shape (128, 112, 112, 64) in
bf16: whether y's bits (NaNs too), idx and dx equal the plain
versions' on an input with ties, NaNs and an all-(-inf) window, and
each kernel's device time (CUDA graphs, CUDA events, as ``chip_smoke.py``
times, on enough distinct buffers that L2 does not hold the inputs),
taken in turns: the sources in order, then in reverse.  Last line: one
JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

VALUE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]
TRAIN_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
#: x of the batch-128 ResNet-50 stem pool (bf16)
SHAPE = (128, 112, 112, 64)
#: each kernel's C entry point
ENTRIES = {"K2a": "tm_maxpool3x3s2", "K2b": "tm_maxpool3x3s2_argmax",
           "K2c": "tm_maxpool3x3s2_bwd"}


def int32_copy(src: Path, dst: Path) -> Path:
    text = src.read_text()
    if not re.search(r"\bint64_t\b", text):
        raise SystemExit(f"{src}: no int64_t to replace")
    dst.write_text(re.sub(r"\bint64_t\b", "int32_t", text))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a version of maxpool.cu (default: the package's)")
    ap.add_argument("--int32-index", action="append", default=[],
                    metavar="NAME",
                    help="also time source NAME with int64_t -> int32_t")
    ap.add_argument("--reps", type=int, default=3,
                    help="passes over the sources (odd passes reversed)")
    ap.add_argument("--out", default="build/probe",
                    help="directory for the SASS dumps and result.json")
    args = ap.parse_args()

    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("maxpool_kernel_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke
    from lrn_kernel_probe import build, sass_counts
    from theanompi_tpu_torch.ops import maxpool

    out_dir = REPO / "build" / "probe"
    dump_dir = REPO / args.out
    dump_dir.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = dict(s.split("=", 1) for s in args.source) or {
        "current": "theanompi_tpu_torch/csrc/maxpool.cu"}
    sources = {k: (REPO / v) for k, v in sources.items()}
    for name in args.int32_index:
        sources[f"{name}+int32"] = int32_copy(sources[name],
                                              out_dir / f"{name}_int32.cu")
    built = build(sources, out_dir)
    card = chip_smoke.card_line()
    clocks = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, "; SM clock max, now:", clocks, flush=True)

    result = {"card": card, "sm_clocks": clocks, "versions": {}}
    fns = {}
    for name, info in built.items():
        counts = sass_counts(info["lib"], dump_dir / f"{name}.sass")
        lib = ctypes.CDLL(str(info["lib"]))
        fns[name] = {}
        for kid, sym in ENTRIES.items():
            fn = getattr(lib, sym)
            fn.argtypes = VALUE_ARGS if kid == "K2a" else TRAIN_ARGS
            fn.restype = ctypes.c_int
            fns[name][kid] = fn
        usage = chip_smoke.ptxas_usage("\n".join(info["ptxas"]))
        result["versions"][name] = {"build_s": info["seconds"],
                                    "ptxas_log": info["ptxas"],
                                    "ptxas": usage, "sass": counts,
                                    "ms": {k: [] for k in ENTRIES}}
        print(f"{name}: built in {info['seconds']:.1f} s", flush=True)
        for fn_name, use in usage.items():
            print(f"  {fn_name}: {use}; SASS {counts.get(fn_name)}")

    n, h, w, c = shape = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(shp):
        return torch.randn(shp, generator=gen, device="cuda").to(
            torch.bfloat16)

    x = rand(shape)
    x[0, 0:2, 0:2, :] = float("-inf")       # all-(-inf) window at (0, 0)
    x[1, 5, 7, :8] = float("nan")
    x[1, 6, 7, :8] = float("nan")           # same window, later tap
    x[3, 40:43, 40:43, :] = 0.5             # ties
    want_y, want_idx = maxpool.maxpool3x3s2_argmax_plain(x)
    g = rand(want_y.shape)
    want_dx = maxpool.maxpool3x3s2_bwd_plain(g, want_idx)
    want_v = maxpool.maxpool3x3s2_plain(x)

    def call(name, kid, xi, yi, ii, gi, di):
        f = fns[name][kid]
        stream = torch.cuda.current_stream().cuda_stream
        if kid == "K2a":
            err = f(xi.data_ptr(), yi.data_ptr(), n, h, w, c, 1, stream)
        elif kid == "K2b":
            err = f(xi.data_ptr(), yi.data_ptr(), ii.data_ptr(), n, h, w, c,
                    1, stream)
        else:
            err = f(gi.data_ptr(), ii.data_ptr(), di.data_ptr(), n, h // 2,
                    w // 2, c, 1, stream)
        if err:
            raise RuntimeError(f"{name} {kid}: cudaError {err}")

    for name in fns:
        y, idx = torch.empty_like(want_y), torch.empty_like(want_idx)
        dx, yv = torch.empty_like(x), torch.empty_like(want_y)
        call(name, "K2b", x, y, idx, None, None)
        call(name, "K2c", None, None, want_idx, g, dx)
        call(name, "K2a", x, yv, None, None, None)
        torch.cuda.synchronize()
        exact = {"K2b": chip_smoke.same_bits(torch, y, want_y)
                 and torch.equal(idx, want_idx),
                 "K2c": torch.equal(dx, want_dx),
                 "K2a": chip_smoke.same_bits(torch, yv, want_v)}
        result["versions"][name]["exact"] = exact
        print(f"{name}: exact against the plain versions {exact}",
              flush=True)
        if not all(exact.values()):
            raise SystemExit(f"{name}: differs from the plain versions")
    del x, g, want_y, want_idx, want_dx, want_v, y, idx, dx, yv
    torch.cuda.empty_cache()

    n_in = math.prod(shape)
    n_out = n_in // 4
    nbytes = 2 * n_in + 3 * n_out
    copies = chip_smoke.copies_for(nbytes)
    xs = [rand(shape) for _ in range(copies)]
    ys = [torch.empty((n, h // 2, w // 2, c), dtype=torch.bfloat16,
                      device="cuda") for _ in range(copies)]
    ids = [maxpool.maxpool3x3s2_argmax_plain(t)[1] for t in xs]
    gs = [rand(ys[0].shape) for _ in range(copies)]
    dxs = [torch.empty_like(xs[0]) for _ in range(copies)]
    reps = max(2, 40 // copies)
    order = list(fns)
    for p in range(args.reps):
        for name in (order if p % 2 == 0 else order[::-1]):
            for kid in ENTRIES:
                result["versions"][name]["ms"][kid].append(
                    chip_smoke.graph_ms(torch, [
                        (lambda i=i, nm=name, k=kid: call(
                            nm, k, xs[i], ys[i], ids[i], gs[i], dxs[i]))
                        for i in range(copies)], reps))
    bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    result.update(shape=list(shape), bound_ms_k2b_k2c=bound,
                  bound_ms_k2a=(2 * n_in + 2 * n_out)
                  / chip_smoke.HBM_BYTES_PER_S * 1e3)
    summary = {}
    for name in order:
        ms = result["versions"][name]["ms"]
        best = {kid: min(v) for kid, v in ms.items()}
        result["versions"][name]["best_ms"] = best
        summary[name] = best
        print(f"{name} {list(shape)} bf16 ms (best of {args.reps}): "
              + ", ".join(f"{kid} {v:.4f} ({ms[kid]})"
                          for kid, v in best.items())
              + f"; K2b/K2c bound {bound:.4f}", flush=True)
    (dump_dir / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
