#!/usr/bin/env python3
"""A/B probe of the port's fused-BN backward kernels (K1c, K1d;
``theanompi_tpu_torch/csrc/fused_bn.cu``) on one NVIDIA card: registers,
spills and device times of two or more versions of the source side by
side, at every (rows, C) of the backward of a batch-128 ResNet-50 step
(bf16) and of a batch-64 GoogLeNet step (bf16, the unit scale of its
``BiasAct``).

    python3 tools/fused_bn_kernel_probe.py \\
        --source old=build/fused_bn_parent.cu \\
        --source new=theanompi_tpu_torch/csrc/fused_bn.cu \\
        --out chiprun_out/fused_bn_probe

(the parent's source taken with ``git show <commit>:theanompi_tpu_torch/
csrc/fused_bn.cu > build/fused_bn_parent.cu``).  ``--variant
NAME=BASE:kBwdMaxCluster=4,kBwdBlocksPerSm=1`` adds a copy of source BASE
with those ``constexpr int`` constants changed (timed, never used by the
port).  Each source is compiled with the port's nvcc flags into its own
library under ``build/probe_fused_bn/`` (one nvcc each, all started
together, ``lrn_kernel_probe.build``).  A source is the one-launch
version when it defines ``tm_scale_bias_act_bwd_geometry`` (the scratch
is sized from the library's own geometry), else the two-pass version
(``bwd_tiles`` of that version's wrapper); a one-launch source is built
from a copy with ``OCCUPANCY_CU`` appended, a host function that the
port's library does not carry.  ``--phases NAME`` also builds a copy of source NAME
whose kernel stamps the GPU's nanosecond clock at each of ``PHASES``
(thread 0 of each block) and prints, at ``PHASE_SHAPES``, when the
blocks reach each phase (never timed beside the others).  For each
library: each backward instance's ``-Xptxas -v`` registers and spills;
for the one-launch versions the clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``).
At each case: dx/dres 0 ulp against the plain version and ds/db within
1e-5 of sum|g'x| and sum|g'| for every version, ds/db bit-identical over
two launches, then each version's device time (CUDA graphs, CUDA events,
as ``chip_smoke.py`` times, on enough distinct buffers that L2 does not
hold the inputs), in turns: the versions in order, then in reverse.
Sums per step are launches per step times the best time.  Last line:
one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# x, scale, bias, res, g, dx, dres, part, ds, db; rows, c, tiles, dtype,
# relu; stream
TWO_PASS_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
#: the one-launch entry point: the same with tickets after part and the
#: scratch sizes after c
ONE_LAUNCH_ARGS = [ctypes.c_void_p] * 11 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
RESNET_BATCH, GOOGLENET_BATCH = 128, 64
#: appended to a one-launch source: the clusters of `cluster` blocks of
#: one backward instance that the card holds at once, at the shared
#: memory of (rows, c) (cudaOccupancyMaxActiveClusters)
OCCUPANCY_CU = r'''
namespace {
template <typename T, bool RES, bool RELU>
cudaError_t probe_max_clusters(int cluster, size_t smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
      out, scale_bias_act_bwd_cluster_kernel<T, RES, RELU>, &cfg);
}

template <typename T>
cudaError_t probe_max_clusters_of(int res, int relu, int cluster,
                                  size_t smem, int* out) {
  if (res)
    return relu ? probe_max_clusters<T, true, true>(cluster, smem, out)
                : probe_max_clusters<T, true, false>(cluster, smem, out);
  return relu ? probe_max_clusters<T, false, true>(cluster, smem, out)
              : probe_max_clusters<T, false, false>(cluster, smem, out);
}
}  // namespace

extern "C" int tm_probe_bwd_max_clusters(int dtype, int res, int relu,
                                         int cluster, long long rows, int c,
                                         int* out) {
  const int n = dtype == 1 ? 8 : 4;
  const size_t smem = bwd_smem(bwd_geometry(rows, c / n, n), n);
  return (int)(dtype == 1
                   ? probe_max_clusters_of<__nv_bfloat16>(res, relu, cluster,
                                                          smem, out)
                   : probe_max_clusters_of<float>(res, relu, cluster, smem,
                                                  out));
}
'''


def two_pass_tiles(rows: int, c: int, elt: int) -> int:
    """Row tiles of the two-pass version (its wrapper's ``bwd_tiles``)."""
    cv = c // (16 // elt)
    lanes = min(cv, 256)
    groups, chunks = 256 // lanes, -(-cv // lanes)
    return max(1, min(-(-rows // (groups * 8)), max(1, 528 // chunks)))


def one_launch(src: Path) -> bool:
    return "tm_scale_bias_act_bwd_geometry" in src.read_text()


def occupancy_copy(src: Path, dst: Path) -> Path:
    """A copy of a one-launch source with OCCUPANCY_CU appended."""
    dst.write_text(src.read_text() + OCCUPANCY_CU)
    return dst


def variant_copy(src: Path, dst: Path, consts: str) -> Path:
    text = src.read_text()
    for item in consts.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                          rf"\g<1>{int(value)};", text)
        if n != 1:
            raise SystemExit(f"{src}: no constexpr int {name}")
    dst.write_text(text)
    return dst


class Version:
    """One built library and how to call its backward entry point."""

    def __init__(self, torch, name: str, lib: Path):
        self.torch, self.name = torch, name
        self.lib = ctypes.CDLL(str(lib))
        self.fn = self.lib.tm_scale_bias_act_bwd
        self.one_launch = hasattr(self.lib, "tm_scale_bias_act_bwd_geometry")
        self.fn.argtypes = (ONE_LAUNCH_ARGS if self.one_launch
                            else TWO_PASS_ARGS)
        self.fn.restype = ctypes.c_int
        if self.one_launch:
            geo = self.lib.tm_scale_bias_act_bwd_geometry
            geo.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_longlong)]
            geo.restype = ctypes.c_int
            occ = self.lib.tm_probe_bwd_max_clusters
            occ.argtypes = [ctypes.c_int] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            occ.restype = ctypes.c_int

    def geometry(self, rows: int, c: int, dtype_code: int) -> list[int]:
        out = (ctypes.c_longlong * 13)()
        if self.lib.tm_scale_bias_act_bwd_geometry(rows, c, dtype_code,
                                                   out):
            raise SystemExit(f"{self.name}: no geometry for {(rows, c)}")
        return list(out)

    def max_clusters(self, dtype_code, res, relu, cluster, rows, c) -> int:
        out = ctypes.c_int(0)
        err = self.lib.tm_probe_bwd_max_clusters(
            dtype_code, res, relu, cluster, rows, c, ctypes.byref(out))
        return out.value if err == 0 else -err

    def __call__(self, x, s, b, r, g, dx, dres, ds, db, relu: bool) -> None:
        torch = self.torch
        rows, c = x.shape
        code = 1 if x.dtype == torch.bfloat16 else 0
        stream = torch.cuda.current_stream().cuda_stream
        ptr = (lambda t: None if t is None else t.data_ptr())
        if self.one_launch:
            geo = self.geometry(rows, c, code)
            part = torch.empty(geo[8], dtype=torch.float32, device=x.device)
            tickets = torch.empty(geo[9], dtype=torch.int32, device=x.device)
            err = self.fn(x.data_ptr(), s.data_ptr(), b.data_ptr(), ptr(r),
                          g.data_ptr(), dx.data_ptr(), ptr(dres),
                          part.data_ptr(), tickets.data_ptr(), ds.data_ptr(),
                          db.data_ptr(), rows, c, geo[8], geo[9], code,
                          int(relu), stream)
        else:
            tiles = two_pass_tiles(rows, c, x.element_size())
            part = torch.empty(2 * tiles * c, dtype=torch.float32,
                               device=x.device)
            err = self.fn(x.data_ptr(), s.data_ptr(), b.data_ptr(), ptr(r),
                          g.data_ptr(), dx.data_ptr(), ptr(dres),
                          part.data_ptr(), ds.data_ptr(), db.data_ptr(),
                          rows, c, tiles, code, int(relu), stream)
        if err:
            raise RuntimeError(f"{self.name}: cudaError {err} at "
                               f"{(rows, c)}")


def backward_cases(torch, chip_smoke) -> list[dict]:
    """(model, rows, C, residual, act, per step, unit scale) of every
    K1c/K1d of a ResNet-50 step at batch 128 and a GoogLeNet step at 64,
    read with forward hooks (``chip_smoke.k1_cases``)."""
    from theanompi_tpu_torch.models.googlenet import GoogLeNetCNN
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    # the fixed cost of a call: a shape with almost no bytes
    out = [dict(model="floor", rows=256, C=64, residual=False, act="relu",
                per_step=0, unit_scale=False)]
    model = ResNet50(device="cuda")
    x0 = torch.zeros((RESNET_BATCH, 224, 224, 3), dtype=torch.uint8,
                     device="cuda")
    cases = chip_smoke.k1_cases(torch, model.module,
                                model.data.device_transform(x0))
    del model, x0
    out += [dict(model="resnet50", rows=r, C=c, residual=res, act=act,
                 per_step=n, unit_scale=False)
            for (r, c, res, act), n in sorted(cases.items())]
    with torch.device("cuda"):
        module = GoogLeNetCNN(dtype=torch.bfloat16)
    x = torch.zeros((GOOGLENET_BATCH, 224, 224, 3), device="cuda")
    cases = chip_smoke.k1_cases(torch, module, x, train=True)
    del module, x
    out += [dict(model="googlenet", rows=r, C=c, residual=res, act=act,
                 per_step=n, unit_scale=True)
            for (r, c, res, act), n in sorted(cases.items())]
    torch.cuda.empty_cache()
    return out


#: where a --phases copy stamps %globaltimer (thread 0 of each block),
#: before each marker of the one-launch source; stamp 3 follows the first
#: cluster barrier and stamp 7 the last, so the two are placed apart
PHASES = ("start", "loop end", "tree end", "cluster barrier",
          "slice written", "ticket", "last slice end", "exit")
_PHASE_MARKS = (("  if (grp < groups && cvi < cv) {\n", 0),
                ("  // the block: row groups added pairwise", 1),
                ("  // the cluster: block `rank` adds its slice", 2),
                ('  asm volatile("barrier.cluster.arrive.release;" ::: '
                 '"memory");\n', 4),
                ("    if (last_sh) {\n", 5))
_WAIT = '  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");\n'
#: (rows, C, residual) the --phases copy runs at, bf16 under relu
PHASE_SHAPES = ((256, 64, False), (3136, 128, False), (12544, 64, False),
                (50176, 32, False), (6272, 512, False), (25088, 256, False),
                (100352, 128, False), (401408, 64, False),
                (25088, 1024, True))


def stamp(i: int) -> str:
    return ("  if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
            '"mov.u64 %0, %%globaltimer;" : "=l"(t_)); tm_phase_ns[(blockIdx.y'
            f" * gridDim.x + blockIdx.x) * 8 + {i}] = t_; }}\n")


def phases_copy(src: Path, dst: Path) -> Path:
    """A copy of a one-launch source whose kernel stamps the GPU's
    nanosecond clock at each of PHASES, read back by tm_phase_read."""
    text = src.read_text()
    text = text.replace("namespace {\n", "__device__ unsigned long long "
                        "tm_phase_ns[8 * 4096];\nnamespace {\n", 1)
    for mark, i in _PHASE_MARKS:
        if text.count(mark) != 1:
            raise SystemExit(f"{src}: no single {mark!r} to stamp")
        text = text.replace(mark, stamp(i) + mark)
    sync = "  cluster.sync();\n  for (int e = e0 +"
    end = _WAIT + "}\n"
    if text.count(sync) != 1 or text.count(end) != 1:
        raise SystemExit(f"{src}: no single cluster barrier or exit to stamp")
    text = text.replace(sync, "  cluster.sync();\n" + stamp(3)
                        + sync[len("  cluster.sync();\n"):])
    text = text.replace(end, stamp(6) + _WAIT + stamp(7) + "}\n")
    text += ("\nextern \"C\" int tm_phase_read(unsigned long long* out, "
             "int n) {\n  return (int)cudaMemcpyFromSymbol(out, tm_phase_ns, "
             "n * 8);\n}\n")
    dst.write_text(text)
    return dst


def phase_table(torch, v: Version) -> list[dict]:
    """Per block, us from the first block's start to each of PHASES (min
    / median / max over the blocks), at PHASE_SHAPES, from the last of 6
    eager calls on fresh buffers."""
    import statistics

    read = v.lib.tm_phase_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = []
    for rows, c, res in PHASE_SHAPES:
        def rand():
            return torch.randn(rows, c, generator=gen,
                               device="cuda").bfloat16()

        s = torch.rand(c, generator=gen, device="cuda") + 0.5
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        ds, db = (torch.empty(c, device="cuda") for _ in range(2))
        for _ in range(6):
            x, g = rand(), rand()
            r = rand() if res else None
            v(x, s, b, r, g, torch.empty_like(x),
              torch.empty_like(x) if res else None, ds, db, True)
        torch.cuda.synchronize()
        geo = v.geometry(rows, c, 1)
        blocks = geo[7] * geo[2]
        ns = (ctypes.c_ulonglong * (8 * blocks))()
        if read(ctypes.cast(ns, ctypes.c_void_p), 8 * blocks):
            raise SystemExit("tm_phase_read failed")
        t = [ns[8 * k:8 * k + 8] for k in range(blocks)]
        t0 = min(row[0] for row in t)
        rec = {"rows": rows, "C": c, "residual": res, "blocks": blocks,
               "clusters": geo[6], "us": {}}
        for i, name in enumerate(PHASES):
            vals = sorted((row[i] - t0) / 1e3 for row in t if row[i])
            if vals:
                rec["us"][name] = [vals[0], statistics.median(vals),
                                   vals[-1]]
        out.append(rec)
        print(f"  phases ({rows}, {c}{', res' if res else ''}), {blocks} "
              f"blocks, {geo[6]} clusters, us min/median/max: " + "; ".join(
                  f"{k} {a:.2f}/{m:.2f}/{z:.2f}"
                  for k, (a, m, z) in rec["us"].items()), flush=True)
    return out


def profiled_us(torch, chip_smoke, call, n: int, calls: int = 20) -> dict:
    """Device us per call by event name (kernels and memsets) of
    ``calls`` eager calls traced with torch.profiler, and ``span``: from
    the first event's start to the last one's end, per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            call(i % n)
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    start, end = float("inf"), 0.0
    for e in prof.events():
        if not chip_smoke.device_kernel(torch, e):
            continue
        key = e.name if len(e.name) < 40 else e.name[:37] + "..."
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / calls
        start = min(start, e.time_range.start)
        end = max(end, e.time_range.end)
    if out:
        out["span"] = (end - start) / calls
    return out


def node_costs(torch, chip_smoke) -> dict:
    """Device us per replay of a graph of one 4-byte cudaMemsetAsync (the
    tickets' zeroing) and of one 1-element fill kernel: what a node of
    the call costs whatever its work."""
    t = torch.empty(1, dtype=torch.int32, device="cuda")
    out = {"fill_kernel": 1e3 * chip_smoke.graph_ms(
        torch, [lambda: t.zero_()], reps=40)}
    major = torch.version.cuda.split(".")[0]
    try:
        cudart = ctypes.CDLL(f"libcudart.so.{major}")
    except OSError as e:
        out["memset"] = f"libcudart not found: {e}"
        return out
    cudart.cudaMemsetAsync.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_size_t, ctypes.c_void_p]
    out["memset"] = 1e3 * chip_smoke.graph_ms(torch, [
        lambda: cudart.cudaMemsetAsync(
            t.data_ptr(), 0, 4, torch.cuda.current_stream().cuda_stream)],
        reps=40)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a version of fused_bn.cu (default: the package's)")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=BASE:CONST=V[,CONST=V]",
                    help="a copy of source BASE with constants changed")
    ap.add_argument("--reps", type=int, default=2,
                    help="passes over the versions (odd passes reversed)")
    ap.add_argument("--models", default="resnet50,googlenet",
                    help="cases of these models (resnet50, googlenet)")
    ap.add_argument("--phases", metavar="NAME",
                    help="also build a copy of one-launch source NAME whose "
                         "kernel stamps the clock at each phase, and print "
                         "the phases' times at PHASE_SHAPES")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 20 eager calls of each version with "
                         "torch.profiler: device us per call by kernel")
    ap.add_argument("--out", default="build/probe_fused_bn",
                    help="directory for result.json")
    args = ap.parse_args()

    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("fused_bn_kernel_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from lrn_kernel_probe import build
    from theanompi_tpu_torch.ops import fused_bn

    build_dir = REPO / "build" / "probe_fused_bn"
    out_dir = REPO / args.out
    build_dir.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = dict(s.split("=", 1) for s in args.source) or {
        "current": "theanompi_tpu_torch/csrc/fused_bn.cu"}
    sources = {k: (REPO / v) for k, v in sources.items()}
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        base, consts = rest.split(":", 1)
        sources[name] = variant_copy(sources[base], build_dir / f"{name}.cu",
                                     consts)
    if args.phases:
        sources[f"{args.phases}+phases"] = phases_copy(
            sources[args.phases], build_dir / f"{args.phases}_phases.cu")
    sources = {k: (occupancy_copy(v, build_dir / f"{k}_occupancy.cu")
                   if one_launch(v) else v) for k, v in sources.items()}
    built = build(sources, build_dir)
    card = chip_smoke.card_line()
    clocks = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, "; SM clock max, now:", clocks, flush=True)
    result = {"card": card, "sm_clocks": clocks, "versions": {},
              "cases": []}
    versions = {}
    for name, info in built.items():
        usage = {k: v for k, v in chip_smoke.ptxas_usage(
            "\n".join(info["ptxas"])).items() if "bwd" in k or "tiles" in k}
        versions[name] = v = Version(torch, name, info["lib"])
        rec = {"build_s": info["seconds"], "one_launch": v.one_launch,
               "ptxas": usage}
        print(f"{name}: built in {info['seconds']:.1f} s, "
              f"{'one launch' if v.one_launch else 'two passes'}",
              flush=True)
        for fn_name, use in usage.items():
            print(f"  {fn_name}: {use}")
        if v.one_launch:
            occ = {}
            for code, dt in ((1, "bf16"), (0, "f32")):
                for res in (0, 1):
                    for cl in (1, 2, 4, 8):
                        occ[f"{dt} res={res} cluster={cl}"] = v.max_clusters(
                            code, res, 1, cl, 6272, 2048)
            rec["max_active_clusters_at_6272x2048"] = occ
            print(f"  max active clusters (relu, smem of 6272x2048): {occ}")
        result["versions"][name] = rec
    if args.phases:
        name = f"{args.phases}+phases"
        print(f"{name}: the kernel's phases (thread 0 of each block, "
              "%globaltimer)", flush=True)
        result["phases"] = phase_table(torch, versions.pop(name))

    result["graph_node_us"] = node_costs(torch, chip_smoke)
    print(f"one graph node alone: {result['graph_node_us']}", flush=True)
    cases = [c for c in backward_cases(torch, chip_smoke)
             if c["model"] in ["floor", *args.models.split(",")]]
    gen = torch.Generator(device="cuda").manual_seed(20)
    names = list(versions)
    for case in cases:
        rows, c, has_res = case["rows"], case["C"], case["residual"]
        relu = case["act"] == "relu"
        dtype = torch.bfloat16
        nbytes = rows * c * 2 * (5 if has_res else 3) + 4 * c * 4
        n = chip_smoke.copies_for(nbytes)

        def rand():
            return torch.randn(rows, c, generator=gen,
                               device="cuda").to(dtype)

        xs = [rand() for _ in range(n)]
        gs = [rand() for _ in range(n)]
        rs = [rand() if has_res else None for _ in range(n)]
        s = (torch.ones(c, device="cuda") if case["unit_scale"] else
             torch.rand(c, generator=gen, device="cuda") + 0.5)
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        dxs = [torch.empty_like(xs[0]) for _ in range(n)]
        dres = [torch.empty_like(xs[0]) if has_res else None
                for _ in range(n)]
        ds, db = (torch.empty(c, device="cuda") for _ in range(2))
        want = fused_bn._bwd_plain(xs[0], s, b, rs[0], gs[0], relu)
        gm = gs[0].float()
        if relu:
            z = xs[0].float() * s + b + (rs[0].float() if has_res else 0)
            gm = torch.where(z > 0, gm, 0)
        ds_mag = (gm * xs[0].float()).abs().sum(0).clamp_min(1e-30)
        db_mag = gm.abs().sum(0).clamp_min(1e-30)
        del gm
        rec = dict(case, bound_ms=chip_smoke.bound_ms(
            nbytes, rows * c * (4 + has_res + 3)), checks={},
            ms={k: [] for k in names})
        for name, v in versions.items():
            v(xs[0], s, b, rs[0], gs[0], dxs[0], dres[0], ds, db, relu)
            torch.cuda.synchronize()
            ulp = chip_smoke.ulp_distance(torch, dxs[0], want[0])
            if has_res:
                ulp = max(ulp, chip_smoke.ulp_distance(torch, dres[0],
                                                       want[1]))
            ds_rel = float(((ds - want[2]).abs() / ds_mag).max())
            db_rel = float(((db - want[3]).abs() / db_mag).max())
            first = (ds.clone(), db.clone())
            v(xs[0], s, b, rs[0], gs[0], dxs[0], dres[0], ds, db, relu)
            torch.cuda.synchronize()
            same = (chip_smoke.same_bits(torch, first[0], ds)
                    and chip_smoke.same_bits(torch, first[1], db))
            rec["checks"][name] = {"ulp": ulp, "ds_rel": ds_rel,
                                   "db_rel": db_rel, "repeat_same": same}
            if ulp or ds_rel > 1e-5 or db_rel > 1e-5 or not same:
                raise SystemExit(f"{name} at {case}: dx/dres {ulp} ulp, ds "
                                 f"{ds_rel:.3g}, db {db_rel:.3g}, repeat "
                                 f"bit-identical {same}")
        del want
        for p in range(args.reps):
            for name in (names if p % 2 == 0 else names[::-1]):
                v = versions[name]
                rec["ms"][name].append(chip_smoke.graph_ms(torch, [
                    (lambda i=i, v=v: v(xs[i], s, b, rs[i], gs[i], dxs[i],
                                        dres[i], ds, db, relu))
                    for i in range(n)], reps=max(2, 40 // n)))
        rec["best_ms"] = {k: min(v) for k, v in rec["ms"].items()}
        if args.profile:
            rec["profiled_us"] = {name: profiled_us(
                torch, chip_smoke, lambda i, v=v: v(
                    xs[i], s, b, rs[i], gs[i], dxs[i], dres[i], ds, db, relu),
                n) for name, v in versions.items()}
        result["cases"].append(rec)
        print(f"  {case['model']:9s} rows={rows:7d} C={c:5d} "
              f"res={int(has_res)} act={case['act']!s:5s} "
              f"x{case['per_step']:2d}/step bound "
              f"{rec['bound_ms'] * 1e3:8.2f} us  " + "  ".join(
                  f"{k} {t * 1e3:8.2f} us" for k, t in
                  rec["best_ms"].items()), flush=True)
        for name, per in rec.get("profiled_us", {}).items():
            print(f"    {name} traced per call: " + ", ".join(
                f"{k} {v:.2f} us" for k, v in per.items()), flush=True)
        del xs, gs, rs, dxs, dres
        torch.cuda.empty_cache()

    summary = {}
    for model in args.models.split(","):
        for kid, res in (("K1c", False), ("K1d", True)):
            sel = [r for r in result["cases"]
                   if r["model"] == model and r["residual"] == res]
            if not sel:
                continue
            summary[f"{model} {kid}"] = {
                "bound_ms": sum(r["per_step"] * r["bound_ms"] for r in sel),
                **{k: sum(r["per_step"] * r["best_ms"][k] for r in sel)
                   for k in names}}
    result["per_step"] = summary
    for key, row in summary.items():
        print(f"{key} per step: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
    (out_dir / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
