"""Training recorder: calc/comm/wait section timers + metric curves.

Counterpart of ``theanompi_tpu/utils/recorder.py``.  The step call
returns before the card finishes (CUDA work is asynchronous), so a wall
timer around it measures the enqueue; ``end(section, block_on=...)``
first fences on the card that holds ``block_on`` (a tensor or a
structure of tensors), so 'calc' means device time.  Output is JSONL,
one record per epoch.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any

import numpy as np
import torch

from theanompi_tpu_torch import monitor


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_fence(tree: Any) -> None:
    """Wait until the card(s) holding the tensors in ``tree`` have
    finished the work queued so far (a CUDA synchronize per device)."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Recorder:
    SECTIONS = ("calc", "comm", "wait", "load")

    def __init__(self, rank: int = 0, size: int = 1,
                 print_freq: int = 40, save_dir: str | None = None,
                 flops_per_sample: float | None = None):
        self.rank = rank
        self.size = size
        self.print_freq = print_freq
        self.save_dir = save_dir
        #: trained FLOPs per sample (model-declared): lets the epoch
        #: record report achieved TFLOP/s per rank
        self.flops_per_sample = flops_per_sample
        self._t0: float | None = None
        self.epoch_time: dict[str, float] = defaultdict(float)
        self.train_losses: list[float] = []
        self.train_errors: list[float] = []
        self.epoch_records: list[dict] = []
        self.n_images = 0
        self._epoch_start = time.monotonic()
        self.epoch = 0

    # -- section timing (reference API shape: start() ... end('calc')) --

    def start(self) -> None:
        self._t0 = time.monotonic()

    def end(self, section: str, block_on: Any = None) -> float:
        """Close the open section.  If ``block_on`` holds tensors on a
        card, wait for that card first (``device_fence``), so device
        time is charged to this section rather than to whoever touches
        the value next."""
        if section not in self.SECTIONS:
            raise ValueError(f"unknown section {section!r}")
        if self._t0 is None:
            raise RuntimeError("Recorder.end() without start()")
        if block_on is not None:
            device_fence(block_on)
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.epoch_time[section] += dt
        # thin client of the telemetry registry: every closed section
        # also lands in the section-time histogram (count+sum there are
        # the per-section span totals; no-op when monitoring is off)
        monitor.observe("recorder/section_ms", dt * 1e3, section=section,
                        rank=str(self.rank))
        return dt

    # -- metric accumulation --

    def train_metrics(self, loss: float, error: float, n_images: int) -> None:
        self.train_losses.append(float(loss))
        self.train_errors.append(float(error))
        self.n_images += int(n_images)

    def print_train_info(self, it: int) -> None:
        # cadence is the caller's business (models flush pending device
        # metrics every print_freq iterations and then call this)
        if self.rank != 0 or self.print_freq <= 0:
            return
        window = self.train_losses[-self.print_freq:]
        werr = self.train_errors[-self.print_freq:]
        print(
            f"[epoch {self.epoch} it {it}] "
            f"loss {np.mean(window):.4f} err {np.mean(werr):.4f} "
            f"calc {self.epoch_time['calc']:.1f}s "
            f"load {self.epoch_time['load']:.1f}s "
            f"wait {self.epoch_time['wait']:.1f}s",
            flush=True,
        )

    def epoch_summary(self, epoch: int, val_loss: float | None = None,
                      val_error: float | None = None) -> dict:
        wall = time.monotonic() - self._epoch_start
        rec = {
            "epoch": epoch,
            "wall_time_s": round(wall, 3),
            "images_per_sec": round(self.n_images / wall, 2) if wall > 0 else 0.0,
            "tflops_per_shard": (
                round(self.n_images / wall / max(self.size, 1)
                      * self.flops_per_sample / 1e12, 2)
                if wall > 0 and self.flops_per_sample else None),
            "train_loss": float(np.mean(self.train_losses)) if self.train_losses else None,
            "train_error": float(np.mean(self.train_errors)) if self.train_errors else None,
            "val_loss": None if val_loss is None else float(val_loss),
            "val_error": None if val_error is None else float(val_error),
            "time": {k: round(self.epoch_time[k], 3) for k in self.SECTIONS},
        }
        self.epoch_records.append(rec)
        monitor.inc("recorder/epochs_total", rank=str(self.rank))
        monitor.set_gauge("recorder/images_per_sec",
                          rec["images_per_sec"], rank=str(self.rank))
        if self.rank == 0:
            print(
                f"== epoch {epoch}: {rec['images_per_sec']} img/s, "
                f"train_loss {rec['train_loss']}, val_error {rec['val_error']}, "
                f"calc/comm/wait/load = "
                + "/".join(f"{rec['time'][k]}" for k in self.SECTIONS),
                flush=True,
            )
        if self.save_dir is not None:
            self.save(self.save_dir)
        # reset per-epoch accumulators
        self.epoch_time = defaultdict(float)
        self.train_losses, self.train_errors = [], []
        self.n_images = 0
        self._epoch_start = time.monotonic()
        self.epoch = epoch + 1
        return rec

    # -- persistence --

    def save(self, save_dir: str) -> str:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, f"record_rank{self.rank}.jsonl")
        with open(path, "w") as f:
            for rec in self.epoch_records:
                f.write(json.dumps(rec) + "\n")
        return path
