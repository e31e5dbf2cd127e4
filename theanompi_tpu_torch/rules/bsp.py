"""BSP: synchronous data-parallel training.

Counterpart of ``theanompi_tpu/rules/bsp.py``: the epoch driver (train
steps, validation, LR schedule, checkpoint and resume, recorder
bookkeeping) over the model's BSP steps (parallel/bsp.py).

Checkpoints (on by default): after each epoch's ``adjust_hyperp``, rank 0
saves the model's canonical payload to ``<snapshot_dir>/<model.name>/``
(utils/checkpoint.py; every rank holds the same state after a BSP step,
apart from its error-feedback residual, which every rank's payload
gathers into one ``(n_ranks, ...)`` tensor per parameter).
``resume=True`` restores the newest checkpoint that verifies on every
rank (rank 0 first: it alone quarantines a corrupt epoch), loads it into
the module and the optimizer, checks that the restored state's digest
equals the one taken at save, reloads the recorder's records and
fast-forwards the LR schedule, then goes on from the next epoch.
``profile_dir`` (or ``THEANOMPI_TPU_PROFILE``) traces the first steps
(utils/profiling.py).

Each epoch record (the recorder's, returned under ``records``) also
holds the epoch's training steps, validation batches and training wall
seconds (``train_steps``, ``val_batches``, ``train_s``; the wall ends
after the last metrics flush, which waits for the card, and before
validation and the save), and the kernel launches (ops/_kernels.py) of
its training steps and of its validation pass (``launches``:
``{"train": {...}, "val": {...}}``), so a run shows which kernels it went
through.  With checkpoints the result also holds ``checkpoint``: each
save's pause of the training thread, the seconds of its background
parts (``write_s``, ``digest_s``, ``manifest_s``), the checkpoint's
bytes, and the restore's epoch, seconds and digests; and rank 0's epoch
records split the training steps by the part of an earlier save that
was running in the background when each step ended (``ckpt_overlap``:
``{"none" | "write" | "digest" | "manifest" | ...: {"steps", "s",
"wait_s"}}``, ``wait_s`` being the loader wait inside those steps), so
a run reads what a save costs the steps it overlaps beside the steps
no save overlaps.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.models.base import TorchModel
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.rules.base import Rule, resolve_model_class
from theanompi_tpu_torch.utils.checkpoint import Checkpointer, state_digest
from theanompi_tpu_torch.utils.profiling import StepProfiler
from theanompi_tpu_torch.utils.recorder import Recorder


def _restore(model: TorchModel, ckpt: Checkpointer | None,
             ckpt_dir: str) -> dict | None:
    """Restore the newest verified checkpoint into ``model`` on every
    rank; returns what was restored (None: nothing to restore)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    t0 = time.monotonic()
    if model.rank != 0:
        dist.barrier()  # rank 0 has quarantined what is corrupt
        reader = (Checkpointer(ckpt_dir, read_only=True)
                  if os.path.isdir(ckpt_dir) else None)
    else:
        reader = ckpt
    epoch, payload = (reader.restore_latest_verified() if reader is not None
                      else (None, None))
    if model.rank == 0 and world > 1:
        dist.barrier()
    if world > 1:
        epochs = [None] * world
        dist.all_gather_object(epochs, epoch)
        if len(set(epochs)) != 1:
            raise RuntimeError(f"ranks restored different epochs: {epochs}")
    if payload is None:
        return None
    model.adopt_restored_state(payload)
    restore_s = time.monotonic() - t0
    saved = reader.saved_digest(epoch)
    restored = state_digest(model.checkpoint_payload())
    if model.rank != 0:
        reader.close()
    if saved is not None and saved != restored:
        raise RuntimeError(
            f"checkpoint epoch {epoch} in {ckpt_dir}: the restored state's "
            f"digest {restored} differs from the digest at save {saved}")
    return {"epoch": int(epoch), "s": restore_s,
            "digest_s": time.monotonic() - t0 - restore_s,
            "digest_at_save": saved, "digest_restored": restored}


def run_bsp_session(model: TorchModel, sync_type: str = "avg",
                    resume: bool = False, recorder: Recorder | None = None,
                    max_epochs: int | None = None,
                    checkpoint: bool = True,
                    profile_dir: str | None = None,
                    monitor_dir: str | None = None) -> dict:
    """The BSP epoch loop on this process's card (module docstring).
    ``max_epochs`` caps the epochs this call runs; ``monitor_dir`` (or
    ``THEANOMPI_TPU_MONITOR``) turns on the step-time histogram and the
    per-phase spans."""
    cfg = model.config
    recorder = recorder or Recorder(
        rank=model.rank, size=model.n_workers, print_freq=cfg.print_freq,
        save_dir=cfg.snapshot_dir if model.rank == 0 else None,
        flops_per_sample=model.train_flops_per_sample)
    profiler = StepProfiler(profile_dir)
    ckpt_dir = os.path.join(cfg.snapshot_dir, model.name)
    ckpt = None
    restored = None
    saves: list[dict] = []
    with monitor.session(monitor_dir, rank=model.rank):
        monitor.progress(phase="compile")
        with monitor.span("bsp/compile"):
            model.compile_iter_fns(sync_type)
        start_epoch = 0
        if checkpoint:
            if model.rank == 0:  # every rank holds the same state
                ckpt = Checkpointer(ckpt_dir)
            if resume:
                restored = _restore(model, ckpt, ckpt_dir)
                if restored is not None:
                    start_epoch = restored["epoch"] + 1
                    recorder.load(cfg.snapshot_dir, before_epoch=start_epoch)
                    # the saved param groups carry the LR of the epoch
                    # after the restored one; set it from the schedule
                    model.adjust_hyperp(start_epoch)
        n_epochs = (model.n_epochs if max_epochs is None
                    else min(model.n_epochs, start_epoch + max_epochs))
        last_val: dict = {}
        with profiler:  # its exit writes the trace, also on a crash
            try:
                for epoch in range(start_epoch, n_epochs):
                    monitor.set_gauge("bsp/epoch", epoch)
                    with monitor.span("bsp/epoch"):
                        counts = [_kernels.launch_counts()]
                        t_epoch = time.monotonic()
                        n_iters = model.begin_epoch(epoch)
                        it = 0
                        overlap: dict[str, list] = {}
                        while it < n_iters:
                            t0 = time.monotonic()
                            wait0 = recorder.epoch_time["wait"]
                            with profiler.label(it):
                                it += model.train_iter(it, recorder)
                            dt = time.monotonic() - t0
                            monitor.observe_step(dt, phase="train", step=it)
                            if ckpt is not None:
                                o = overlap.setdefault(
                                    ckpt.background() or "none", [0, 0.0, 0.0])
                                o[0] += 1
                                o[1] += dt
                                o[2] += recorder.epoch_time["wait"] - wait0
                            profiler.step()
                        model._flush_metrics(recorder)
                        train_s = time.monotonic() - t_epoch
                        counts.append(_kernels.launch_counts())
                        monitor.progress(phase="validate")
                        with monitor.span("bsp/validate"):
                            last_val = model.val_epoch(recorder)
                        counts.append(_kernels.launch_counts())
                        model.adjust_hyperp(epoch + 1)
                        if checkpoint:
                            monitor.progress(phase="checkpoint")
                            t0 = time.monotonic()
                            with monitor.span("bsp/checkpoint"):
                                # every rank: with error feedback the
                                # payload gathers each rank's residual
                                payload = model.checkpoint_payload(epoch)
                                if ckpt is not None:
                                    ckpt.save(epoch, payload)
                            if ckpt is not None:
                                saves.append({"epoch": epoch, "pause_ms": (
                                    time.monotonic() - t0) * 1e3})
                        extra = {"train_steps": it,
                                 "val_batches": model.val_batches_run,
                                 "train_s": round(train_s, 6),
                                 "launches": {
                                     "train": _delta(counts[0], counts[1]),
                                     "val": _delta(counts[1], counts[2])}}
                        if ckpt is not None:
                            extra["ckpt_overlap"] = {
                                part: {"steps": n, "s": round(sec, 6),
                                       "wait_s": round(wait, 6)}
                                for part, (n, sec, wait) in overlap.items()}
                        recorder.epoch_summary(
                            epoch, last_val.get("loss"),
                            last_val.get("error"), extra=extra)
                        monitor.progress(phase="epoch_end", step=epoch)
            finally:
                model.cleanup()  # also on failure: stops the prefetcher
                if ckpt is not None:
                    ckpt.close()
    result = {"val": last_val, "epochs_run": n_epochs - start_epoch,
              "records": recorder.epoch_records}
    if checkpoint:
        result["checkpoint"] = {
            "saves": [{**s, **(ckpt.timings.get(s["epoch"], {})
                               if ckpt is not None else {})}
                      for s in saves],
            "restore": restored}
    if profiler.trace_path:
        result["profile_trace"] = profiler.trace_path
    return result


def _delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


class BSP(Rule):
    """Synchronous BSP data-parallel rule: one process per card.

    ``model_parallel``/``seq_parallel``/``pipe_parallel``/
    ``expert_parallel`` carve those axes out of the ranks (the rest go to
    ``data``): the model is built on that mesh (parallel/mesh.py), as
    JAX's rule builds it; with every degree 1 it gets none.  A model
    that sets no ``batch_partition`` (the zoo: its rows over ``data``
    alone) refuses them, where JAX would leave the other axes idle."""

    name = "BSP"
    uses_global_mesh = True

    def _session(self, device, modelfile, modelclass, config, resume,
                 sync_type, max_epochs=None, checkpoint=True,
                 profile_dir: str | None = None,
                 monitor_dir: str | None = None, model_parallel: int = 1,
                 seq_parallel: int = 1, pipe_parallel: int = 1,
                 expert_parallel: int = 1, **kwargs):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        cls = resolve_model_class(modelfile, modelclass)
        if max(model_parallel, seq_parallel, pipe_parallel,
               expert_parallel) > 1:
            from theanompi_tpu_torch.parallel.mesh import (
                MeshSpec,
                make_training_mesh,
            )

            if cls.batch_partition is None:
                raise ValueError(
                    f"{cls.__name__} trains on the data axis alone; the "
                    "model/seq/pipe/expert degrees need a model of the "
                    "transformer family")
            kwargs["mesh"] = make_training_mesh(MeshSpec(
                data=-1, model=model_parallel, seq=seq_parallel,
                pipe=pipe_parallel, expert=expert_parallel))
        self.model = cls(config=config, device=device, **kwargs)
        self.result = run_bsp_session(self.model, sync_type=sync_type,
                                      resume=resume, max_epochs=max_epochs,
                                      checkpoint=checkpoint,
                                      profile_dir=profile_dir,
                                      monitor_dir=monitor_dir)
