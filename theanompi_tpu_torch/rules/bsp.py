"""BSP: synchronous data-parallel training.

Counterpart of ``theanompi_tpu/rules/bsp.py``: the epoch driver (train
steps, validation, LR schedule, recorder bookkeeping) over the model's
BSP steps (parallel/bsp.py).  Checkpoints are not ported yet
(``utils/checkpoint.py``, ROADMAP.md section A, item 10): ``checkpoint``
defaults to False here, and ``checkpoint=True``, ``resume=True`` or a
``profile_dir`` raise ``NotImplementedError``.

Each epoch record (the recorder's, returned under ``records``) also
holds the epoch's training steps, validation batches and training wall
seconds (``train_steps``, ``val_batches``, ``train_s``; the wall ends
after the last metrics flush, which waits for the card), and the kernel
launches (ops/_kernels.py) of its training steps and of its validation
pass (``launches``: ``{"train": {...}, "val": {...}}``), so a run shows
which kernels it went through.
"""

from __future__ import annotations

import time

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.models.base import TorchModel
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.rules.base import Rule, resolve_model_class
from theanompi_tpu_torch.utils.recorder import Recorder


def run_bsp_session(model: TorchModel, sync_type: str = "avg",
                    resume: bool = False, recorder: Recorder | None = None,
                    max_epochs: int | None = None,
                    checkpoint: bool = False,
                    profile_dir: str | None = None,
                    monitor_dir: str | None = None) -> dict:
    """The BSP epoch loop on this process's card.  ``monitor_dir`` (or
    ``THEANOMPI_TPU_MONITOR``) turns on the step-time histogram and the
    per-phase spans."""
    for what, on in (("checkpoint=True", checkpoint), ("resume=True", resume),
                     ("profile_dir", profile_dir)):
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet (checkpoints and the step "
                "profiler: ROADMAP.md section A, item 10)")
    cfg = model.config
    recorder = recorder or Recorder(
        rank=model.rank, size=model.n_workers, print_freq=cfg.print_freq,
        save_dir=cfg.snapshot_dir if model.rank == 0 else None,
        flops_per_sample=model.train_flops_per_sample)
    with monitor.session(monitor_dir, name=f"rank{model.rank}"):
        monitor.progress(phase="compile")
        with monitor.span("bsp/compile"):
            model.compile_iter_fns(sync_type)
        n_epochs = (model.n_epochs if max_epochs is None
                    else min(model.n_epochs, max_epochs))
        last_val: dict = {}
        try:
            for epoch in range(n_epochs):
                monitor.set_gauge("bsp/epoch", epoch)
                with monitor.span("bsp/epoch"):
                    counts = [_kernels.launch_counts()]
                    t_epoch = time.monotonic()
                    n_iters = model.begin_epoch(epoch)
                    it = 0
                    while it < n_iters:
                        t0 = time.monotonic()
                        it += model.train_iter(it, recorder)
                        monitor.observe_step(time.monotonic() - t0,
                                             phase="train", step=it)
                    model._flush_metrics(recorder)
                    train_s = time.monotonic() - t_epoch
                    counts.append(_kernels.launch_counts())
                    monitor.progress(phase="validate")
                    with monitor.span("bsp/validate"):
                        last_val = model.val_epoch(recorder)
                    counts.append(_kernels.launch_counts())
                    model.adjust_hyperp(epoch + 1)
                    recorder.epoch_summary(
                        epoch, last_val.get("loss"), last_val.get("error"),
                        extra={"train_steps": it,
                               "val_batches": model.val_batches_run,
                               "train_s": round(train_s, 6),
                               "launches": {
                                   "train": _delta(counts[0], counts[1]),
                                   "val": _delta(counts[1], counts[2])}})
                    monitor.progress(phase="epoch_end", step=epoch)
        finally:
            model.cleanup()  # also on failure: stops the prefetcher
    return {"val": last_val, "epochs_run": n_epochs,
            "records": recorder.epoch_records}


def _delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


class BSP(Rule):
    """Synchronous BSP data-parallel rule: one process per card."""

    name = "BSP"

    def _session(self, device, modelfile, modelclass, config, resume,
                 sync_type, max_epochs=None, checkpoint=False,
                 monitor_dir: str | None = None, **kwargs):
        cls = resolve_model_class(modelfile, modelclass)
        self.model = cls(config=config, device=device, **kwargs)
        self.result = run_bsp_session(self.model, sync_type=sync_type,
                                      resume=resume, max_epochs=max_epochs,
                                      checkpoint=checkpoint,
                                      monitor_dir=monitor_dir)
