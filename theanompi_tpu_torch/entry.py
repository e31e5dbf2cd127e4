"""Entry points of the port for a one-card check and a multi-rank dry
run (counterpart of the JAX package's ``__graft_entry__.py``).

``entry(device)``  — ``(fn, example_args)``: the flagship model's eval
                     forward, a bf16 full (3, 4, 6, 3) ResNet-50 at
                     ``(8, 224, 224, 3)``, for a one-card check.
``dryrun_multichip(n, device)`` — the BSP training step's legs, each
                     run once over ``n`` ranks, one process per rank
                     (gloo on the CPU, NCCL on cards): plain BSP,
                     ``sync_bn``, ZeRO-1 and FSDP with
                     ``steps_per_call=2`` and ``grad_accum_steps=2`` on a
                     tiny ResNet-50; at even ``n`` also the
                     TransformerLM's SP, TP, PP and EP legs on a
                     ``(data=2, <axis>=n/2)`` mesh, with JAX's degree
                     rules (TP only where its degree is at least 2 and
                     divides 32).  Returns each leg's loss, launches and
                     the ranks' parameter digests, and asserts the losses
                     finite and the replicas equal.

No environment variable picks the platform: the caller's ``device``
does, and ``device="cuda"`` raises on a machine without a card.

    python -m theanompi_tpu_torch.entry [--device cpu] [-n 4]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from theanompi_tpu_torch._device import resolve_device

#: the legs run at every rank count, then the LM's at even counts
RESNET_LEGS = ("bsp", "sync_bn", "zero", "fsdp", "accum")
LM_LEGS = ("sp", "tp", "pp", "ep")
#: the tiny ResNet-50 of the dryrun (JAX's)
TINY_RESNET = dict(stage_sizes=(1, 1, 1, 1), width=8, crop=32)


def entry(device: str = "cuda"):
    """Return ``(fn, example_args)``: ``fn(net, x)`` is the eval forward
    of a bf16 full ResNet-50 (seeded recipe weights) on ``device``, and
    ``x`` a zero batch of ``(8, 224, 224, 3)`` f32 images."""
    from theanompi_tpu_torch.models.resnet50 import ResNet, init_resnet

    dev = resolve_device(device)
    net = ResNet(dtype=torch.bfloat16)
    init_resnet(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    x = torch.zeros((8, 224, 224, 3), dtype=torch.float32, device=dev)

    def fwd(net, x):
        with torch.no_grad():
            return net(x, train=False)

    return fwd, (net, x)


def resnet_launches(net, train: bool) -> dict[str, int]:
    """The kernel launches one forward of ResNet ``net`` makes (``train``:
    one training step, forward and backward), derived from the module:
    every ``BatchNormAct`` is one fused-BN epilogue, the residual one of
    each block's exit BN, and the stem pool one max-pool."""
    from theanompi_tpu_torch.models.layers import BatchNormAct

    n_bn = sum(isinstance(m, BatchNormAct) for m in net.modules())
    n_res = len(net.blocks)
    out = {"scale_bias_act": n_bn - n_res, "scale_bias_act_res": n_res}
    if not train:
        return dict(out, maxpool3x3s2=1)
    return dict(out, scale_bias_act_bwd=n_bn - n_res,
                scale_bias_act_res_bwd=n_res, maxpool3x3s2_argmax=1,
                maxpool3x3s2_bwd=1)


def lm_degree(leg: str, n: int) -> int | None:
    """The degree of LM leg ``leg`` over ``n`` ranks, or None where JAX's
    rules skip it (odd ``n``; TP below 2 or not dividing 32)."""
    if n % 2:
        return None
    ways = n // 2
    if leg == "tp" and (ways < 2 or 32 % ways):
        return None
    return ways


def legs_for(n: int) -> list[str]:
    return list(RESNET_LEGS) + [leg for leg in LM_LEGS
                                if lm_degree(leg, n) is not None]


def _digest(named) -> str:
    """sha256 of the tensors of ``named`` (f32 bytes, in name order)."""
    h = hashlib.sha256()
    for name, t in sorted(named):
        h.update(name.encode())
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _resnet_model(n: int, device, **cfg):
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    config = ModelConfig(batch_size=4, n_epochs=1, compute_dtype="float32",
                         print_freq=1, track_top5=False, **cfg)
    data = ImageNet_data(crop=TINY_RESNET["crop"],
                         synthetic_n=4 * n * 8, synthetic_pool=16,
                         synthetic_store=40, augment_on_device=True)
    return ResNet50(config=config, device=device,
                    stage_sizes=TINY_RESNET["stage_sizes"],
                    width=TINY_RESNET["width"], crop=TINY_RESNET["crop"],
                    n_classes=data.n_classes, data=data)


def _lm_model(leg: str, n: int, device):
    from theanompi_tpu_torch.models import transformer as T
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.parallel.mesh import (
        MeshSpec,
        make_training_mesh,
    )

    ways = lm_degree(leg, n)
    config = ModelConfig(batch_size=4 if leg == "pp" else 2, n_epochs=1,
                         compute_dtype="float32", print_freq=10**9,
                         learning_rate=0.1, lr_schedule="constant")
    dims = dict(vocab=32, seq_len=16, n_layers=1, d_model=32, n_heads=4)
    if leg == "sp":
        mesh = make_training_mesh(MeshSpec(data=2, seq=ways))
        return T.TransformerLM(config=config, device=device, mesh=mesh,
                               **dict(dims, seq_len=8 * ways))
    if leg == "tp":
        mesh = make_training_mesh(MeshSpec(data=2, model=ways))
        return T.TransformerLM_TP(config=config, device=device, mesh=mesh,
                                  **dict(dims, n_heads=max(4, ways)))
    if leg == "pp":
        mesh = make_training_mesh(MeshSpec(data=2, pipe=ways))
        return T.TransformerLM_PP(config=config, device=device, mesh=mesh,
                                  n_microbatches=2,
                                  **dict(dims, n_layers=ways))
    mesh = make_training_mesh(MeshSpec(data=2, expert=ways))
    return T.TransformerLM_MoE(config=config, device=device, mesh=mesh,
                               n_experts=2 * ways, **dims)


def run_leg(leg: str, n: int, device) -> dict:
    """One leg on this rank (every rank of the group calls it together):
    one ``train_iter`` after ``begin_epoch``; its loss, the batches it
    consumed, the kernel launches it made and a digest of the whole
    parameters after it."""
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.utils.recorder import Recorder

    cfg = {"bsp": {}, "sync_bn": {"sync_bn": True},
           "zero": {"zero_sharding": True, "steps_per_call": 2},
           "fsdp": {"fsdp_sharding": True, "steps_per_call": 2},
           "accum": {"grad_accum_steps": 2}}
    model = (_resnet_model(n, device, **cfg[leg]) if leg in cfg
             else _lm_model(leg, n, device))
    model.compile_iter_fns("avg")
    rec = Recorder(rank=1, size=n, print_freq=10**9)  # rank != 0: silent
    n_iters = model.begin_epoch(0)
    _kernels.reset_launch_counts()
    consumed = model.train_iter(0, rec)
    model._flush_metrics(rec)
    launches = {k: v for k, v in _kernels.launch_counts().items() if v}
    loss = model.current_info.get("loss")
    if leg in ("zero", "fsdp"):
        assert model.state.sharding is not None, f"{leg}: no shard state"
    if hasattr(model, "whole_state_dict"):
        digest = _digest(model.whole_state_dict().items())
    else:
        with model.full_params():
            digest = _digest(model.module.named_parameters())
    model.cleanup()
    return {"loss": loss, "consumed": consumed, "n_iters": n_iters,
            "launches": launches, "digest": digest,
            "degree": lm_degree(leg, n) if leg in LM_LEGS else n}


def _rank_main(rank: int, world: int, port: int, device: str,
               out: str) -> None:
    import torch.distributed as dist

    cuda = torch.device(device).type == "cuda"
    if cuda:
        if world > torch.cuda.device_count():
            raise RuntimeError(f"{world} ranks need {world} cards, have "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = resolve_device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        result = {leg: run_leg(leg, world, dev) for leg in legs_for(world)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """Run every leg of :func:`legs_for` once over ``n_devices`` ranks,
    one process per rank; returns ``{leg: {"loss", "consumed",
    "launches", "degree", "digests"}}`` (loss and launches of rank 0, a
    digest per rank) and raises unless every rank ended, every loss is
    finite and every rank's parameters after each leg are equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun over {n_devices} ranks needs as many "
                           f"cards, have {torch.cuda.device_count()}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    port = _free_port()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="tm_dryrun_") as out:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "theanompi_tpu_torch.entry", "--rank",
             str(r), "--world", str(n_devices), "--port", str(port),
             "--device", dev.type, "--out", out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, t0 + timeout - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log) for r, (p, log)
               in enumerate(zip(procs, logs)) if p.returncode != 0]
        if bad:
            r, rc, log = bad[0]
            raise RuntimeError(f"dryrun rank {r} exited {rc}:\n{log[-4000:]}")
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    result = {}
    for leg in legs_for(n_devices):
        per = [rk[leg] for rk in ranks]
        loss = per[0]["loss"]
        assert loss is not None and math.isfinite(loss), (
            f"bad {leg} loss {loss}")
        digests = [p["digest"] for p in per]
        assert len(set(digests)) == 1, f"{leg}: replicas differ {digests}"
        result[leg] = {k: per[0][k] for k in
                       ("loss", "consumed", "n_iters", "launches", "degree")}
        result[leg]["digests"] = digests
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's entry() forward, then dryrun_multichip")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("-n", type=int, default=None,
                    help="ranks of the dryrun (default: the card count "
                         "on cuda, 4 on the CPU)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.port, args.device, args.out)
        return 0
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry ok:", tuple(out.shape), out.dtype)
    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 4)
    for leg, r in dryrun_multichip(n, args.device).items():
        print(f"  {leg}: loss {r['loss']:.6f} degree {r['degree']} "
              f"launches {r['launches']}")
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
