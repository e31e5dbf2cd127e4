"""Pipeline parallelism over the mesh's ``pipe`` axis (GPipe fill-drain).

Counterpart of ``theanompi_tpu/parallel/pipeline.py``.  JAX runs every
stage in one SPMD program and differentiates through its ``lax.scan`` of
``ppermute`` ticks; PyTorch cannot, so the schedule is written out here,
on each rank of the ``pipe`` group (an ``AxisGroup``, parallel/mesh.py):

* **forward**: microbatch i enters stage 0 (``inject``: the embedding),
  each stage runs its blocks on it under activation checkpointing (JAX's
  ``remat=True`` around the per-tick stage body) and sends its output to
  the next stage (point-to-point over the ``pipe`` group), microbatch by
  microbatch, so the stages fill and drain as in GPipe;
* **backward**: the microbatches in reverse; the last stage seeds each
  from its loss (``head_loss``: the final norm, the head and the
  cross-entropy) weighted by ``1/M``, so the gradients are those of the
  mean over the whole local batch that JAX takes; every other stage
  takes its output's gradient from the next stage, and each stage but
  the first sends its input's gradient upstream.

The masked-loss convention is JAX's: the loss and metrics are real on
the last stage and zero elsewhere, so the step sums them over ``pipe``
and then averages over ``data``; the gradients of the replicated
parameters (the embedding and ``pos_emb`` on stage 0, ``ln_f`` and the
head on the last stage, zero elsewhere) are summed over ``pipe``
(:func:`sum_over_pipe`, JAX's ``pipe_psum_mask``).  A pipe group of one
rank sends nothing.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint


def _recv(shape, dtype, device, src: int) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(t, src=src)
    return t


def gpipe_forward_backward(inject: Callable, stage_fn: Callable,
                           head_loss: Callable, tokens: torch.Tensor,
                           targets: torch.Tensor, pipe,
                           n_microbatches: int, act_shape: tuple,
                           act_dtype: torch.dtype) -> dict:
    """One GPipe forward and backward on this stage (module docstring);
    the gradients land in ``.grad``.  ``inject(tokens_mb)`` -> the stage-0
    input of one microbatch, ``stage_fn(x)`` -> this stage's output,
    ``head_loss(y, targets_mb)`` -> (loss, error) on the last stage;
    ``act_shape`` is one microbatch's activation shape.  Returns the
    metrics: the mean of the microbatches' on the last stage, zeros
    elsewhere."""
    s, n = (0, 1) if pipe is None else (pipe.index, pipe.size)
    m = n_microbatches
    mb = tokens.shape[0] // m
    first, last = s == 0, s == n - 1
    device = tokens.device
    saved, sends = [], []
    for i in range(m):
        if first:
            inp = inject(tokens[i * mb:(i + 1) * mb])
        else:
            inp = _recv(act_shape, act_dtype, device,
                        pipe.peer(s - 1)).requires_grad_()
        out = checkpoint(stage_fn, inp, use_reentrant=False)
        if not last:
            y = out.detach().contiguous()
            sends.append((dist.isend(y, pipe.peer(s + 1)), y))
        saved.append((inp, out))
    for work, _ in sends:
        work.wait()
    loss = torch.zeros((), device=device)
    err = torch.zeros((), device=device)
    sends = []
    for i in reversed(range(m)):
        inp, out = saved.pop()
        if last:
            loss_i, err_i = head_loss(out, targets[i * mb:(i + 1) * mb])
            (loss_i / m).backward()
            loss = loss + loss_i.detach() / m
            err = err + err_i.detach() / m
        else:
            out.backward(_recv(out.shape, out.dtype, device,
                               pipe.peer(s + 1)))
        if not first:
            g = inp.grad.contiguous()
            sends.append((dist.isend(g, pipe.peer(s - 1)), g))
    for work, _ in sends:
        work.wait()
    return {"loss": loss, "error": err}


@torch.no_grad()
def gpipe_forward(inject: Callable, stage_fn: Callable, head_metrics:
                  Callable, tokens: torch.Tensor, targets: torch.Tensor,
                  pipe, n_microbatches: int, act_shape: tuple,
                  act_dtype: torch.dtype) -> dict:
    """The eval pass through the pipeline: the microbatches' outputs are
    gathered on the last stage, whose ``head_metrics(y, targets)`` over
    the whole local batch are the metrics; zeros elsewhere."""
    s, n = (0, 1) if pipe is None else (pipe.index, pipe.size)
    m = n_microbatches
    mb = tokens.shape[0] // m
    outs = []
    for i in range(m):
        if s == 0:
            x = inject(tokens[i * mb:(i + 1) * mb])
        else:
            x = _recv(act_shape, act_dtype, tokens.device, pipe.peer(s - 1))
        y = stage_fn(x)
        if s < n - 1:
            dist.send(y.contiguous(), pipe.peer(s + 1))
        outs.append(y)
    if s < n - 1:
        return None
    return head_metrics(torch.cat(outs), targets)


def sum_over_pipe(tensors: list[torch.Tensor], pipe) -> None:
    """Sum ``tensors`` over the ``pipe`` group in place, with one
    collective over a flat buffer (none over one rank)."""
    if pipe is None or pipe.trivial or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=pipe.group)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
