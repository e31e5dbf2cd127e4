#!/usr/bin/env python3
"""Plain BSP, ZeRO-1, FSDP and the LM family's mesh degrees through the
port's launcher at N ranks.

    python3 tools/sharded_bsp_probe.py -D 2 -D 4 \
        --out build/sharded_summary.json
    python3 tools/sharded_bsp_probe.py -D 4 --knob sp --knob tp \
        --knob pp --knob ep

For each world size and each knob (``plain``, ``sync``: ``--set
sync_bn=true``, ``zero``: ``--set zero_sharding=true``, ``fsdp``: ``--set
fsdp_sharding=true``) it runs
``python -m theanompi_tpu_torch.launcher BSP -D N`` on the same model,
data and seed, and reports, per run: the bytes each rank keeps of the
parameters, the optimizer state and the residual (the result JSON's
``state_bytes``), the ranks' state digests (equal: the ranks agree), the
ms per training step of its one epoch, and the distance of ZeRO's final
parameters, BN statistics (and FSDP's per-parameter momentum too) from
its twin's at the same N (ZeRO: plain BSP; FSDP: plain BSP with
``sync_bn``, since FSDP's BN statistics are the global batch's):
largest absolute difference and relative L2, 0 when bit-identical.
Without ``--model`` it trains full-width ResNet-50 (bf16, batch 128 a
rank) on a shard tree it cuts from the port's
synthetic pool (``--steps`` batches of 128 per rank), on the cards;
``--platform cpu`` runs gloo ranks (give a small ``--model``, e.g.
``test_torch_resilience:TinyResNetEF`` with ``PYTHONPATH=tests``).
The LM knobs (``--knob``; the default runs the four above) each run
``launcher BSP -D N --<axis>-parallel 2`` (``LM_DEGREE``):
``sp`` the ``TransformerLM`` over ``seq``, ``tp`` ``TransformerLM_TP``
over ``model``, ``pp`` ``TransformerLM_PP`` over ``pipe`` and ``ep``
``TransformerLM_MoE`` over ``expert``, the classes taken from
``--lm-module`` (default the port's models/transformer.py at their
default sizes; a test module can give smaller ones), and report the same
ms a step, bytes a rank and the ranks' agreement (each rank's checkpoint
payload holds the whole tree, so the digests agree).
Runs whose ranks fit on disjoint cards go side by side, each with its
own ``CUDA_VISIBLE_DEVICES``.  Data, snapshots, result JSONs and each
run's log go under ``--work``; the summary is printed as one JSON line
and written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
#: each run's --set, and the run it is held against: FSDP's BN
#: statistics are the global batch's, so its twin is plain BSP with
#: sync_bn
KNOBS = {"plain": (), "sync": ("sync_bn=true",),
         "zero": ("zero_sharding=true",), "fsdp": ("fsdp_sharding=true",)}
TWINS = {"zero": "plain", "fsdp": "sync"}
#: the LM knobs: the mesh axis each carves out, and the model class
LM_KNOBS = {"sp": ("seq", "TransformerLM"), "tp": ("model", "TransformerLM_TP"),
            "pp": ("pipe", "TransformerLM_PP"),
            "ep": ("expert", "TransformerLM_MoE")}
#: the LM knobs' degree on their axis (the rest of -D goes to data)
LM_DEGREE = 2


def shard_tree(root: str, n_batches: int, batch: int) -> str:
    """A shard tree of ``n_batches`` training and 2 validation batches of
    ``batch`` 256x256 images from the port's synthetic pool."""
    from theanompi_tpu_torch.data.imagenet import (
        ImageNet_data,
        prepare_imagenet_shards,
    )

    pool = ImageNet_data(seed=0, synthetic_n=n_batches * batch,
                         synthetic_pool=64)
    for part, epoch, n in (("train", 0, n_batches), ("val", 1, 2)):
        x, y = next(iter(pool.train_batches(epoch, n * batch)))
        prepare_imagenet_shards(x, y, root, part, shard_size=len(y),
                                shard_format="npy")
    return root


def final_tensors(snap: str, name: str):
    """Parameters, buffers and per-parameter momentum of the newest
    checkpoint under ``snap``, flattened in f64, by name."""
    import torch

    from theanompi_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(os.path.join(snap, name), read_only=True)
    payload = ck.restore(ck.latest_epoch())
    ck.close()
    out = {f"params/{k}": v for k, v in payload["params"].items()}
    out.update({f"model_state/{k}": v
                for k, v in payload["model_state"].items()
                if v.is_floating_point()})
    state = payload["opt_state"]["state"]
    names = list(payload["params"])
    if len(state) == len(names):      # per parameter (plain BSP, FSDP)
        for i, n in enumerate(names):
            for k, v in state[i].items():
                if torch.is_tensor(v) and v.dim() > 0:
                    out[f"opt/{n}/{k}"] = v
    return {k: v.double().reshape(-1) for k, v in out.items()}


def distance(got: dict, ref: dict) -> dict:
    """Per group (params, model_state, opt) of the tensors both hold."""
    import torch

    out = {}
    for group in ("params", "model_state", "opt"):
        keys = sorted(k for k in set(got) & set(ref)
                      if k.startswith(group + "/"))
        if not keys:
            continue
        a = torch.cat([got[k] for k in keys])
        b = torch.cat([ref[k] for k in keys])
        out[group] = {
            "tensors": len(keys), "bit_identical": bool(torch.equal(a, b)),
            "max_abs": float((a - b).abs().max()),
            "rel_l2": float((a - b).norm() / b.norm().clamp_min(1e-300))}
    return out


def run(args, work: str, n: int, knob: str, devices: str | None,
        data_dir: str | None) -> subprocess.Popen:
    model = args.model or "theanompi_tpu_torch.models.resnet50:ResNet50"
    extra: list[str] = []
    if knob in LM_KNOBS:
        axis, cls = LM_KNOBS[knob]
        model = f"{args.lm_module}:{cls}"
        extra = [f"--{axis}-parallel", str(LM_DEGREE)]
        sets = []
    else:
        sets = list(KNOBS[knob])
        if data_dir:
            sets.append(f"data_dir={data_dir}")
    modelfile, modelclass = model.split(":")
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.launcher", "BSP",
           "-D", str(n), "--platform", args.platform, "-m", modelfile,
           "-c", modelclass, "--snapshot-dir",
           os.path.join(work, f"{knob}{n}"), "--result-json",
           os.path.join(work, f"{knob}{n}.json"), "--epochs", "1", *extra,
           *[a for kv in sets for a in ("--set", kv)]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    if devices is not None:
        env["CUDA_VISIBLE_DEVICES"] = devices
    log = open(os.path.join(work, f"{knob}{n}.log"), "w")
    return subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-D", dest="worlds", type=int, action="append",
                   help="world sizes (repeat; default 2)")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--model", help="MODULE:CLASS (default: ResNet-50 on "
                   "a synthetic shard tree)")
    p.add_argument("--steps", type=int, default=8,
                   help="training batches a rank an epoch (default data)")
    p.add_argument("--knob", dest="knobs", action="append",
                   choices=sorted({**KNOBS, **LM_KNOBS}),
                   help="runs to make (repeat; default plain, sync, zero, "
                        "fsdp)")
    p.add_argument("--lm-module",
                   default="theanompi_tpu_torch.models.transformer",
                   help="module holding the LM knobs' classes")
    p.add_argument("--work", default="build/sharded_probe")
    p.add_argument("--out", default=None,
                   help="summary JSON (default <work>/summary.json)")
    args = p.parse_args(argv)
    worlds = args.worlds or [2]
    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    knobs = args.knobs or list(KNOBS)
    data_dir = None
    if args.model is None and any(k in KNOBS for k in knobs):
        data_dir = shard_tree(os.path.join(work, "data"),
                              args.steps * max(worlds), 128)
    if args.platform == "cuda":
        import torch

        cards = torch.cuda.device_count()
    else:
        cards = None
    # waves of runs on disjoint cards (all at once on the CPU)
    queue = [(n, k) for n in worlds for k in knobs]
    results: dict = {}
    t0 = time.monotonic()
    while queue:
        wave, free = [], list(range(cards)) if cards else None
        for n, k in list(queue):
            if free is None or len(free) >= n:
                devs = None
                if free is not None:
                    devs, free = ",".join(map(str, free[:n])), free[n:]
                wave.append((n, k, run(args, work, n, k, devs, data_dir)))
                queue.remove((n, k))
        if not wave:
            raise SystemExit(f"a run needs more than {cards} cards")
        for n, k, proc in wave:
            rc = proc.wait(timeout=3600)
            res = {"rc": rc}
            if rc != 0:
                with open(os.path.join(work, f"{k}{n}.log")) as f:
                    res["log_tail"] = f.read()[-3000:]
            if rc == 0:
                with open(os.path.join(work, f"{k}{n}.json")) as f:
                    r = json.load(f)
                res.update(
                    state_bytes=r["state_bytes"],
                    ranks_agree=len(set(r["state_digests"])) == 1,
                    ms_per_step=[1e3 * e["train_s"] / e["train_steps"]
                                 for e in r["records"]],
                    launches=[e["launches"]["train"] for e in r["records"]])
            results[f"{k}-D{n}"] = res
        print(f"wave {[f'{k}-D{n}' for n, k, _ in wave]} done at "
              f"{time.monotonic() - t0:.1f} s", flush=True)
    for n in worlds:
        for k, twin in TWINS.items():
            if k not in knobs or twin not in knobs:
                continue
            if results[f"{k}-D{n}"]["rc"] or results[f"{twin}-D{n}"]["rc"]:
                continue
            snap = os.path.join(work, f"{twin}{n}")
            name = next(d for d in os.listdir(snap)
                        if os.path.isdir(os.path.join(snap, d)))
            results[f"{k}-D{n}"][f"against_{twin}"] = distance(
                final_tensors(os.path.join(work, f"{k}{n}"), name),
                final_tensors(snap, name))
    if args.platform == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        results["cards"] = out.stdout.strip().splitlines()
    out_path = args.out or os.path.join(work, "summary.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0 if all(r["rc"] == 0 for k, r in results.items()
                    if isinstance(r, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
