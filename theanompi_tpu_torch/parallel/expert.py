"""Expert parallelism over the mesh's ``expert`` axis (switch-style MoE).

Counterpart of ``theanompi_tpu/parallel/expert.py``.  The experts are
cut over the ``expert`` group (each rank owns ``E / ep`` expert FFNs,
stacked on a leading expert axis), the tokens ride the data axes, and a
pair of ``all_to_all_single`` collectives (:class:`_AllToAll`, whose
backward is the same all-to-all: it is its own transpose) regroups the
tokens by expert and back.

Routing is top-1 with a fixed capacity per expert (:func:`top1_dispatch`,
JAX's arithmetic: the first maximum wins the argmax, int32 cumsum queue
positions, tokens beyond capacity dropped with a zero combine weight,
and the switch load-balancing aux loss ``E * sum(frac_tokens *
frac_probs)``).  The dispatch and combine products are plain einsums in
f32, as JAX leaves them to XLA.

:func:`sync_moe_grads` is the step's exchange (JAX's
``make_moe_train_step``): the expert leaves are averaged over ``data``
and divided by ``ep`` (the all-to-all's backward already summed every
expert rank's cotangent onto the owner), the others are averaged over
``data x expert``; 'cdd' keeps sums, JAX's ``grad_scale = n_workers``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def top1_dispatch(router_logits: torch.Tensor, capacity: int):
    """Switch-routing tensors for one rank's tokens.

    ``router_logits``: (n_tokens, E).  Returns ``dispatch`` (E, capacity,
    n_tokens) one-hot (token t is slot s of expert e), ``combine``
    (n_tokens, E, capacity): router-prob weights, zero for dropped
    tokens, and the load-balancing aux loss."""
    n, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    expert_prob, expert_idx = probs.max(dim=-1)        # first max wins
    onehot = F.one_hot(expert_idx, e).to(torch.int32)           # (n, E)
    position = torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot - 1
    pos_in_expert = position.amax(dim=-1)                        # (n,)
    keep = pos_in_expert < capacity
    frac_tokens = onehot.float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    slot = torch.where(keep, pos_in_expert, torch.zeros_like(pos_in_expert))
    dispatch = (F.one_hot(expert_idx, e).float()[:, :, None]
                * F.one_hot(slot.long(), capacity).float()[:, None, :]
                * keep.float()[:, None, None])                # (n, E, cap)
    combine = dispatch * expert_prob[:, None, None]
    return dispatch.permute(1, 2, 0), combine, aux


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of (ep, ...) over the expert group: block j
    to rank j; its own transpose, so the backward is the same op."""

    @staticmethod
    def forward(ctx, x, ep):
        ctx.ep = ep
        return _a2a(x, ep)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.ep), None


def _a2a(x: torch.Tensor, ep) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ep.group)
    return out


def apply_experts(p: dict, tok: torch.Tensor) -> torch.Tensor:
    """Every local expert's FFN on its tokens (E_local, cap, d): ReLU,
    not GELU, as JAX's ``apply_expert``."""
    h = torch.relu(torch.bmm(tok, p["up_kernel"]) + p["up_bias"][:, None])
    return torch.bmm(h, p["down_kernel"]) + p["down_bias"][:, None]


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor,
            expert_params: dict, capacity_factor: float = 1.25, ep=None):
    """Switch-MoE FFN over tokens ``x`` (n_tokens, d); ``expert_params``
    carry a leading LOCAL-expert axis (E/ep a rank).  Returns (out in
    x's dtype, aux loss)."""
    n, d = x.shape
    n_ep = 1 if ep is None else ep.size
    e_local = expert_params["up_kernel"].shape[0]
    e = e_local * n_ep
    capacity = max(1, int(capacity_factor * n / e))
    router_logits = x.float() @ router_kernel                   # (n, E)
    dispatch, combine, aux = top1_dispatch(router_logits, capacity)
    expert_in = torch.einsum("ecn,nd->ecd", dispatch, x.float())
    if n_ep > 1:
        # tokens to the rank owning their expert: from every source rank
        # an (e_local, cap, d) block -> (e_local, ep * cap, d)
        expert_in = _AllToAll.apply(
            expert_in.reshape(n_ep, e_local, capacity, d), ep)
        expert_in = expert_in.transpose(0, 1).reshape(
            e_local, n_ep * capacity, d)
    expert_out = apply_experts(expert_params, expert_in)
    if n_ep > 1:
        # the exact mirror: each source rank's slots back to it
        expert_out = expert_out.reshape(e_local, n_ep, capacity, d)
        expert_out = _AllToAll.apply(expert_out.transpose(0, 1), ep)
        expert_out = expert_out.reshape(e, capacity, d)
    out = torch.einsum("nec,ecd->nd", combine, expert_out)
    return out.to(x.dtype), aux


def sync_moe_grads(expert_grads: list[torch.Tensor],
                   other_grads: list[torch.Tensor], data, data_expert,
                   divide: int | None) -> None:
    """The MoE step's gradient exchange, in place (module docstring):
    expert leaves summed over the ``data`` group, the others over the
    ``data x expert`` group (process groups of parallel/mesh.py; one
    flat all-reduce each, none over one rank), then each divided by
    ``divide`` (the workers, ``data x ep``; None for 'cdd')."""
    from theanompi_tpu_torch.parallel.exchanger import issues

    for grads, group in ((expert_grads, data), (other_grads, data_expert)):
        if not grads:
            continue
        if issues(group):
            flat = torch.cat([t.reshape(-1) for t in grads])
            dist.all_reduce(flat, group=group)
            at = 0
            for t in grads:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
        if divide is not None:
            for t in grads:
                t.div_(divide)
