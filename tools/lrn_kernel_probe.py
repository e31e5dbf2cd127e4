#!/usr/bin/env python3
"""Probe of the port's LRN kernels (K3a/K3b, ``theanompi_tpu_torch/csrc/
lrn.cu``) on one NVIDIA card: instruction counts, registers, and device
times of one or more versions of the source side by side.

    python3 tools/lrn_kernel_probe.py                      # csrc/lrn.cu
    python3 tools/lrn_kernel_probe.py --source old=build/parent/lrn.cu \\
        --source new=theanompi_tpu_torch/csrc/lrn.cu --fast-pow

Each source is compiled with the port's nvcc flags into its own library
under ``build/probe/`` (one nvcc each, all started together).
``--fast-pow`` adds, for each source, a copy with every ``powf(`` call
replaced by ``__powf(`` (the SFU's approximation; not exact, so it is
timed and its ulp distance printed, never used by the port): the time
it saves bounds the share of the accurate ``powf``.  For each library:
the ``-Xptxas -v`` lines, the SASS (``cuobjdump -sass``, written with
the results to ``--out``) with each kernel's instruction count, and,
at AlexNet's two bf16 shapes (128x55x55x96, 128x27x27x256, n = 5), each
entry point's ulp distance from the plain version and its device time
(CUDA graphs, CUDA events, as ``chip_smoke.py`` times), taken in turns:
the sources in order, then in reverse.  Last line: one JSON object.
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
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SHAPES = [(128, 55, 55, 96), (128, 27, 27, 256)]
FWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
#: SASS opcodes counted on their own (LDGSTS: cp.async; BSSY: a
#: divergent branch region)
SASS_KEYS = ("MUFU", "LDS", "STS", "LDG", "STG", "BAR", "LDGSTS", "BSSY")
BWD_ARGS = [ctypes.c_void_p] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]


def build(sources: dict[str, Path], out_dir: Path) -> dict[str, dict]:
    """One nvcc per source, all started together."""
    from theanompi_tpu_torch.ops import _kernels

    nvcc = _kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib, time.monotonic())
    built = {}
    for name, (proc, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        built[name] = {"lib": lib, "seconds": time.monotonic() - t0,
                       "ptxas": [ln.strip() for ln in log.splitlines()
                                 if "Used" in ln or "spill" in ln
                                 or "Compiling" in ln]}
    return built


def sass_counts(lib: Path, dump: Path) -> dict[str, dict]:
    """Static SASS instruction count of each kernel, with its MUFU,
    shared-memory, global-memory, barrier and cp.async instructions."""
    from theanompi_tpu_torch.ops import _kernels

    cuobjdump = Path(_kernels.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    dump.write_text(text)
    counts: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"total": 0, **{key: 0 for key in SASS_KEYS}}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if name and m:
            op = m.group(1)
            if op == "NOP":
                continue
            counts[name]["total"] += 1
            if op in SASS_KEYS:
                counts[name][op] += 1
    return counts


def fast_pow_copy(src: Path, dst: Path) -> Path:
    text = src.read_text()
    n = len(re.findall(r"(?<![\w_])powf\(", text))
    if n == 0:
        raise SystemExit(f"{src}: no powf call to replace")
    dst.write_text(re.sub(r"(?<![\w_])powf\(", "__powf(", text))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a version of lrn.cu (default: the package's)")
    ap.add_argument("--fast-pow", action="store_true",
                    help="also time each source with powf -> __powf")
    ap.add_argument("--reps", type=int, default=2,
                    help="passes over the sources (odd passes reversed)")
    ap.add_argument("--out", default="build/probe",
                    help="directory for the SASS dumps and result.json")
    args = ap.parse_args()

    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("lrn_kernel_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke
    from theanompi_tpu_torch.ops import lrn

    out_dir = REPO / "build" / "probe"
    dump_dir = REPO / args.out
    dump_dir.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = dict(s.split("=", 1) for s in args.source) or {
        "current": "theanompi_tpu_torch/csrc/lrn.cu"}
    sources = {k: (REPO / v) for k, v in sources.items()}
    if args.fast_pow:
        for name, src in list(sources.items()):
            sources[f"{name}+__powf"] = fast_pow_copy(
                src, out_dir / f"{name}_fastpow.cu")
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
        fwd, bwd = lib.tm_lrn_fwd, lib.tm_lrn_bwd
        fwd.argtypes, bwd.argtypes = FWD_ARGS, BWD_ARGS
        fwd.restype = bwd.restype = ctypes.c_int
        fns[name] = (fwd, bwd)
        result["versions"][name] = {"build_s": info["seconds"],
                                    "ptxas": info["ptxas"], "sass": counts,
                                    "shapes": {}}
        print(f"{name}: built in {info['seconds']:.1f} s", flush=True)
        for ln in info["ptxas"]:
            print(f"  {ln}")
        for fn, c in counts.items():
            print(f"  {fn}: {c}")

    gen = torch.Generator(device="cuda").manual_seed(7)
    n, k, alpha, beta = 5, 2.0, 1e-4, 0.75
    a = alpha / n
    order = list(fns)
    for shape in SHAPES:
        numel = math.prod(shape)
        x = (torch.randn(numel, generator=gen, device="cuda")
             * chip_smoke.LRN_SCALE).bfloat16().view(shape)
        g = torch.randn(numel, generator=gen, device="cuda").bfloat16(
        ).view(shape)
        want_y, want_dx = lrn.lrn_plain(x, n), lrn.lrn_bwd_plain(x, g, n)
        copies = chip_smoke.copies_for(3 * numel * 2)
        xs = [x] + [x.clone() for _ in range(copies - 1)]
        gs = [g] + [g.clone() for _ in range(copies - 1)]
        ys = [torch.empty_like(x) for _ in range(copies)]
        reps = max(2, 20 // copies)
        rows = numel // shape[-1]

        def call(name, bwd_pass, i):
            fwd, bwd = fns[name]
            stream = torch.cuda.current_stream().cuda_stream
            if bwd_pass:
                err = bwd(xs[i].data_ptr(), gs[i].data_ptr(),
                          ys[i].data_ptr(), rows, shape[-1], n, k, a,
                          -beta - 1.0, 2.0 * a * beta, 1, stream)
            else:
                err = fwd(xs[i].data_ptr(), ys[i].data_ptr(), rows,
                          shape[-1], n, k, a, -beta, 1, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        for name in order:
            row = result["versions"][name]["shapes"].setdefault(
                str(list(shape)), {"fwd_ms": [], "bwd_ms": []})
            call(name, False, 0)
            torch.cuda.synchronize()
            row["ulp_y"] = chip_smoke.ulp_distance(torch, ys[0], want_y)
            call(name, True, 0)
            torch.cuda.synchronize()
            row["ulp_dx"] = chip_smoke.ulp_distance(torch, ys[0], want_dx)
        for p in range(args.reps):
            for name in (order if p % 2 == 0 else order[::-1]):
                row = result["versions"][name]["shapes"][str(list(shape))]
                for key, bwd_pass in (("fwd_ms", False), ("bwd_ms", True)):
                    row[key].append(chip_smoke.graph_ms(torch, [
                        (lambda i=i, nm=name, b=bwd_pass: call(nm, b, i))
                        for i in range(copies)], reps))
        for name in order:
            row = result["versions"][name]["shapes"][str(list(shape))]
            print(f"{name} {list(shape)}: ulp y {row['ulp_y']} dx "
                  f"{row['ulp_dx']}; fwd ms {row['fwd_ms']}, bwd ms "
                  f"{row['bwd_ms']}", flush=True)
        del xs, gs, ys, x, g, want_y, want_dx
        torch.cuda.empty_cache()
    for name in order:
        shapes = result["versions"][name]["shapes"].values()
        result["versions"][name]["per_step_ms"] = {
            key: sum(min(s[key]) for s in shapes)
            for key in ("fwd_ms", "bwd_ms")}
        print(f"{name}: per AlexNet step (both shapes, best of "
              f"{args.reps}): K3a "
              f"{result['versions'][name]['per_step_ms']['fwd_ms']:.4f} ms"
              f", K3b {result['versions'][name]['per_step_ms']['bwd_ms']:.4f}"
              " ms")
    (dump_dir / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({name: v["per_step_ms"]
                      for name, v in result["versions"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
