#!/usr/bin/env python3
"""Where an f32 MoE gradient on the card parts from the CPU's.

    python3 tools/moe_grad_probe.py [--out build/moe_grad_probe.json]
    python3 tools/moe_grad_probe.py --platform cpu      # tiny rehearsal

One loss gradient of ``TransformerLM_MoE`` (8 experts) and of the dense
``TransformerLM``, cut to ``chip_smoke.P24_MOE_LAYERS`` layers at
``chip_smoke.LM_DIMS``'s width, on ``P24_MOE_TOKENS`` from the same seed:
on the card through K4, on the card through the plain attention, on the
CPU in f32 and on the CPU in f64 (every f32 cast lifted, the attention
differentiated by autograd).  Each is held against the f64 gradient
(relative L2).  The MoE's discrete decisions (routes, tokens kept, the
experts' ReLU gates; ``chip_smoke._DecisionTap``) are counted where two
runs differ, and the CPU's f32 and f64 steps are run again on the card's
decisions.  Each attention backward of the card's MoE step (dq, dk, dv)
is held against the plain path and an f64 reference on its own inputs.
Prints one JSON object; ``--platform cpu`` runs the card's part on the
CPU at a tiny width.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@contextlib.contextmanager
def lifted_to_f64(torch, module):
    """Runs ``module`` in f64: its parameters and compute dtypes, every
    ``Tensor.float()`` and the attention (softmax attention in autograd)."""
    import theanompi_tpu_torch.models.transformer as T

    for m in module.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    module.double()

    def attention(q, k, v, q_pos=None, k_pos=None, causal=False, scale=None):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
            q.shape[-1] ** -0.5 if scale is None else scale)
        if causal:
            i = torch.arange(q.shape[1])
            s = s.masked_fill(i[None, :] > i[:, None], float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    saved = torch.Tensor.float, T.fused_attention
    torch.Tensor.float, T.fused_attention = torch.Tensor.double, attention
    try:
        yield
    finally:
        torch.Tensor.float, T.fused_attention = saved


@contextlib.contextmanager
def plain_attention(attn_mod):
    """K4's wrappers take their plain path on card tensors too."""
    saved = attn_mod._kernels.on_cpu
    attn_mod._kernels.on_cpu = lambda t: True
    try:
        yield
    finally:
        attn_mod._kernels.on_cpu = saved


@contextlib.contextmanager
def captured_backwards(attn_mod, calls: list):
    """Records each ``attention_bwd`` call's inputs and outputs."""
    real = attn_mod.attention_bwd

    def bwd(q, k, v, q_pos, k_pos, lse, g, scale=None, causal=False):
        out = real(q, k, v, q_pos, k_pos, lse, g, scale, causal)
        calls.append(([t.detach().cpu() for t in (q, k, v, q_pos, k_pos,
                                                   lse, g)], scale, causal,
                      [t.detach().cpu() for t in out]))
        return out

    attn_mod.attention_bwd = bwd
    try:
        yield
    finally:
        attn_mod.attention_bwd = real


def attention_bwd_f64(torch, q, k, v, q_pos, k_pos, g, scale, causal):
    q, k, v, g = (t.double() for t in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, g))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if args.platform == "cuda":
        # one card, named as chip_smoke.py names it
        os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

    import torch
    import torch.distributed as dist

    import chip_smoke as C
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import (
        TransformerLM,
        TransformerLM_MoE,
    )
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.ops import attention as A
    from theanompi_tpu_torch.parallel.mesh import MeshSpec, make_training_mesh

    card = args.platform
    if card == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernels.build(["attention"])
        print(C.card_line(), flush=True)
        dims = dict(C.LM_DIMS, n_layers=C.P24_MOE_LAYERS)
        n, t = C.P24_MOE_TOKENS
    else:
        dims = dict(vocab=64, n_layers=2, d_model=32, n_heads=2)
        n, t = 2, 64
    dims["seq_len"] = t
    data = SeqLM_data(vocab=dims["vocab"], seq_len=t, n_train=n, n_val=n,
                      seed=25)
    tokens, targets = (torch.from_numpy(x)
                       for x in next(iter(data.train_batches(0, n))))

    def grads(cls, extra, dev, mode, replay=None, calls=None):
        """(loss, {name: f64 gradient}, the decisions' tap or None)."""
        model = cls(config=C.p24_config("float32", batch_size=n),
                    device=dev, data=data, mesh=mesh, **dims, **extra)
        module = model.module.train()
        ctx = contextlib.ExitStack()
        if mode == "f64":
            ctx.enter_context(lifted_to_f64(torch, module))
        elif mode == "plain":
            ctx.enter_context(plain_attention(A))
        if calls is not None:
            ctx.enter_context(captured_backwards(A, calls))
        tap = (ctx.enter_context(C._DecisionTap(torch, replay))
               if cls is TransformerLM_MoE else None)
        with ctx:
            loss, _ = model.loss_fn(module, (tokens.to(dev),
                                             targets.to(dev)), None)
            loss.backward()
        return (float(loss.detach()), {k: q.grad.detach().cpu().double()
                                       for k, q in module.named_parameters()},
                tap)

    def rel(a, b) -> float:
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        return float((a - b).norm() / b.norm())

    def whole(g: dict):
        return torch.cat([v.reshape(-1) for v in g.values()])

    dist.init_process_group("nccl" if card == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{C.free_port()}",
                            world_size=1, rank=0)
    out: dict = {"dims": dims, "tokens": [n, t]}
    try:
        mesh = make_training_mesh(MeshSpec())
        for kind, cls, extra in (("moe", TransformerLM_MoE, {"n_experts": 8}),
                                 ("dense", TransformerLM, {})):
            calls: list = []
            runs = {"card": grads(cls, extra, card, "f32", calls=calls),
                    "card_plain": grads(cls, extra, card, "plain"),
                    "cpu": grads(cls, extra, "cpu", "f32"),
                    "f64": grads(cls, extra, "cpu", "f64")}
            if kind == "moe":
                own = runs["card"][2]
                runs["cpu_on_card"] = grads(cls, extra, "cpu", "f32", own)
                runs["f64_on_card"] = grads(cls, extra, "cpu", "f64", own)
            ref = runs["f64"][1]
            r = {"loss": {k: v[0] for k, v in runs.items()},
                 "grad_rel_l2_vs_f64": {k: rel(whole(v[1]), whole(ref))
                                        for k, v in runs.items()
                                        if k != "f64"},
                 "grad_rel_l2_card_vs": {k: rel(whole(runs["card"][1]),
                                                whole(v[1]))
                                         for k, v in runs.items()
                                         if k != "card"},
                 "card_vs_cpu_top_params": sorted(
                     ((k, rel(runs["card"][1][k], runs["cpu"][1][k]))
                      for k in ref), key=lambda kv: -kv[1])[:6]}
            if kind == "moe":
                taps = {k: runs[k][2] for k in ("card", "cpu", "f64")}
                r["gates_per_layer"] = [g.numel() for g in taps["card"].gates]
                r["kept"] = {k: v.kept for k, v in taps.items()}
                for what in ("routes", "gates"):
                    r[f"flipped_{what}"] = {
                        f"{a}_vs_{b}": [int((x != y).sum()) for x, y in zip(
                            getattr(taps[a], what), getattr(taps[b], what))]
                        for a, b in (("card", "cpu"), ("card", "f64"),
                                     ("cpu", "f64"))}
            r["attention_bwd_rel_l2"] = []
            for (q, k, v, qp, kp, lse, g), scale, causal, got in calls:
                exact = attention_bwd_f64(torch, q, k, v, qp, kp, g, scale,
                                          causal)
                plain = A.attention_bwd_plain(q, k, v, qp, kp, lse, g, scale,
                                              causal)
                r["attention_bwd_rel_l2"].append({
                    "card_vs_f64": [rel(a, b) for a, b in zip(got, exact)],
                    "plain_vs_f64": [rel(a, b) for a, b in zip(plain, exact)]})
            out[kind] = r
    finally:
        dist.destroy_process_group()
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
