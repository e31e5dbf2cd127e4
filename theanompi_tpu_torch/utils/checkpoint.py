"""Per-epoch checkpoints: save, verified restore, quarantine.

Counterpart of ``theanompi_tpu/utils/checkpoint.py`` (Orbax there) on
``torch.save`` / ``torch.load(weights_only=True)``, with the JAX
directory and manifest contract:

* epoch ``e`` lives in ``<directory>/<e>/`` (``state.pt``, the payload,
  and ``state.sha256``, its :func:`state_digest` at save); a write goes
  to a hidden ``.tmp_<e>`` directory first and is renamed into place, so
  a crash never leaves a half-written epoch directory;
* ``max_to_keep`` (3) newest epochs stay, their ``manifest_{e}.json``
  with them (resilience/recovery.py);
* a proven-corrupt epoch moves to ``quarantine/<e>``.

The payload is the canonical tree ``{params, opt_state, model_state,
epoch, step}`` (``TorchModel.checkpoint_payload``): the module's
parameters and buffers by name, the optimizer's state dict and
``TrainState.step``; with error feedback also ``exchange_residual``,
every rank's residual per parameter name.  A WGAN's payload holds its
two networks and optimizers instead (models/wasserstein_gan.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import queue
import shutil
import sys
import threading
import time
from typing import Any

import torch

from theanompi_tpu_torch.resilience import faults, recovery
from theanompi_tpu_torch.resilience.retry import RetryPolicy

PAYLOAD_FILE = "state.pt"
DIGEST_FILE = "state.sha256"
#: the payload keys a state digest covers (not ``epoch``: a label);
#: ``exchange_residual`` is there only with error feedback, the
#: ``gen_*``/``critic_*`` pairs only in a WGAN's payload (JAX's
#: ``WGANState`` fields)
STATE_KEYS = ("params", "model_state", "opt_state", "step",
              "exchange_residual", "gen_params", "gen_opt",
              "critic_params", "critic_opt")
#: the parts of a save that run in the background, in their order
BACKGROUND_PARTS = ("write", "digest", "manifest")


def _hash_tree(h, x: Any) -> None:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        h.update(f"T{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    elif isinstance(x, dict):
        h.update(b"{")
        for k in sorted(x, key=str):
            h.update(repr(k).encode())
            _hash_tree(h, x[k])
        h.update(b"}")
    elif isinstance(x, (list, tuple)):
        h.update(b"[")
        for v in x:
            _hash_tree(h, v)
        h.update(b"]")
    else:
        h.update(repr(x).encode())


def state_digest(payload: dict) -> str:
    """sha256 of everything in a payload that decides the next step:
    parameters, buffers, optimizer state and step, bit for bit, wherever
    the tensors live.  Equal digests: equal training states."""
    h = hashlib.sha256()
    for key in STATE_KEYS:
        if key in payload:
            h.update(key.encode())
            _hash_tree(h, payload[key])
    return h.hexdigest()


class Checkpointer:
    """Epoch-numbered checkpoints in ``directory`` (module docstring).

    Saves are asynchronous by default: ``save`` fences the previous
    write, copies every tensor of the payload off the card into host
    memory (pinned buffers, reused from save to save) and waits for the
    copies, then returns while a background thread writes the files.
    The next optimizer step updates the parameters in place, so the copy
    must be complete before ``save`` returns; only the file I/O runs in
    the background.  A failed write surfaces at the next fence (the next
    ``save``, ``restore``, ``latest_epoch``, ``kept_epochs`` or
    ``close``), chained to its cause.  ``async_save=False`` writes, and
    writes the manifest, before ``save`` returns.

    The background work of a save runs one part at a time: the writer
    thread writes the payload file (``write``), digests its state
    (``digest``) and hands the landed epoch to a second thread, which
    digests its files into the integrity manifest (``manifest``).
    Manifests are drained only where they are read:
    ``restore_latest_verified``, ``close`` and a synchronous ``save``.
    :meth:`background` names the part running now.  The file is written
    without the zip format's per-record CRC-32: ``torch.load`` never
    checks it, and the manifest's sha256 covers the same bytes, so it
    would nearly double the write's host work for no check.

    ``read_only=True`` is the serving reader's mode: it refuses ``save``,
    writes no manifest, prunes nothing, and ``quarantine_epoch`` is a
    no-op, so a verified load leaves the directory byte-identical.

    ``timings`` holds, per epoch written by this object, the seconds of
    each background part (``write_s``, ``digest_s``, ``manifest_s``) and
    the payload file's bytes (``bytes``)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True, read_only: bool = False):
        self.directory = os.path.abspath(directory)
        self.read_only = read_only
        if read_only and not os.path.isdir(self.directory):
            raise FileNotFoundError(
                f"read-only Checkpointer: {self.directory} does not exist "
                "(a reader must not create the writer's directory)")
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        # transient read-I/O retry on the restore path only: a retried
        # fence could report a failed write as success
        self._retry = RetryPolicy(max_attempts=3, base_delay=0.2,
                                  max_delay=2.0, name="checkpoint_restore")
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None
        self._host: list[torch.Tensor] = []
        #: the background parts running now (membership tests only: the
        #: threads add and discard while the training thread reads)
        self._running: set[str] = set()
        self._manifest_q: queue.Queue = queue.Queue()
        self._manifest_thread: threading.Thread | None = None
        self.timings: dict[int, dict[str, float]] = {}
        if not read_only:
            os.makedirs(self.directory, exist_ok=True)

    # -- the directory ------------------------------------------------------

    def _epochs(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isdir(
            os.path.join(self.directory, n)))

    def _step_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, str(int(epoch)))

    # -- fences and manifests -----------------------------------------------

    def _fence(self) -> None:
        """Join the background write and raise its failure, with the
        checkpoint's context."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise RuntimeError(f"background checkpoint write to "
                               f"{self.directory} failed: {err}") from err

    @contextlib.contextmanager
    def _part(self, name: str):
        self._running.add(name)
        try:
            yield
        finally:
            self._running.discard(name)

    def background(self) -> str | None:
        """The background parts of a save running now, in
        ``BACKGROUND_PARTS`` order and joined by ``+``; None when idle."""
        return "+".join(p for p in BACKGROUND_PARTS
                        if p in self._running) or None

    def _ensure_manifest_worker(self) -> None:
        if (self._manifest_thread is None
                or not self._manifest_thread.is_alive()):
            self._manifest_thread = threading.Thread(
                target=self._manifest_loop, daemon=True,
                name="checkpoint-manifests")
            self._manifest_thread.start()

    def _manifest_loop(self) -> None:
        while True:
            item = self._manifest_q.get()
            if item is None:  # close() sentinel
                self._manifest_q.task_done()
                return
            epoch, step_dir = item
            try:
                t0 = time.monotonic()
                with self._part("manifest"):
                    recovery.write_manifest(self.directory, epoch, step_dir)
                self.timings.setdefault(epoch, {})["manifest_s"] = (
                    time.monotonic() - t0)
                # the fault plane corrupts the epoch after its manifest
                # was written from the good files (bit rot on disk)
                if faults.fire("checkpoint", epoch=epoch) == "truncate":
                    _truncate_largest_file(step_dir)
            except OSError:
                pass  # a full disk or a pruned epoch must not kill anything
            except Exception as e:
                # the worker survives anything, an injected 'raise'
                # included: a dead worker would hang the drain's join
                print(f"[resilience] manifest worker: {type(e).__name__}: "
                      f"{e}", file=sys.stderr, flush=True)
            finally:
                self._manifest_q.task_done()

    def _drain_manifests(self) -> None:
        if not self.read_only:
            self._manifest_q.join()

    # -- save ----------------------------------------------------------------

    def _snapshot(self, payload: Any) -> Any:
        """A copy of ``payload`` whose tensors live in host memory that
        nothing else holds; returns once every copy has completed."""
        srcs: list[torch.Tensor] = []

        def collect(x):
            if isinstance(x, torch.Tensor):
                srcs.append(x.detach())
                return _Slot(len(srcs) - 1)
            if isinstance(x, dict):
                return {k: collect(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(collect(v) for v in x)
            return x

        tree = collect(payload)
        keep = len(self._host) == len(srcs) and all(
            h.shape == s.shape and h.dtype == s.dtype
            and h.is_pinned() == (s.device.type == "cuda")
            for h, s in zip(self._host, srcs))
        if not keep:
            self._host = [torch.empty(s.shape, dtype=s.dtype,
                                      pin_memory=s.device.type == "cuda")
                          for s in srcs]
        cuda = set()
        for h, s in zip(self._host, srcs):
            h.copy_(s, non_blocking=s.device.type == "cuda")
            if s.device.type == "cuda":
                cuda.add(s.device)
        for dev in cuda:  # the copies were queued on each card's stream
            torch.cuda.current_stream(dev).synchronize()

        def fill(x):
            if isinstance(x, _Slot):
                return self._host[x.i]
            if isinstance(x, dict):
                return {k: fill(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(fill(v) for v in x)
            return x

        return fill(tree)

    def _write(self, epoch: int, snap: Any) -> None:
        """Write ``snap`` as epoch ``epoch``, prune what falls out of
        ``max_to_keep``, then queue the epoch's manifest."""
        t0 = time.monotonic()
        tmp = os.path.join(self.directory, f".tmp_{epoch}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, PAYLOAD_FILE)
        with self._part("write"), _without_zip_crc32():
            torch.save(snap, path)
        t1 = time.monotonic()
        with self._part("digest"):
            digest = state_digest(snap)
        with open(os.path.join(tmp, DIGEST_FILE), "w") as f:
            f.write(digest + "\n")
        t2 = time.monotonic()
        dst = self._step_dir(epoch)
        if os.path.isdir(dst):
            # re-saving an epoch (a resume that fell back past it)
            # replaces it; its old manifest goes first
            try:
                os.unlink(recovery.manifest_path(self.directory, epoch))
            except FileNotFoundError:
                pass
            shutil.rmtree(dst)
        os.rename(tmp, dst)
        for old in self._epochs()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        recovery.prune_manifests(self.directory, set(self._epochs()))
        self.timings.setdefault(epoch, {}).update(
            write_s=t1 - t0, digest_s=t2 - t1,
            bytes=float(os.path.getsize(os.path.join(dst, PAYLOAD_FILE))))
        self._manifest_q.put((epoch, dst))
        self._ensure_manifest_worker()

    def _write_in_background(self, epoch: int, snap: Any) -> None:
        try:
            self._write(epoch, snap)
        except BaseException as e:  # raised by the next fence
            self._write_error = e

    def save(self, epoch: int, payload: Any) -> None:
        if self.read_only:
            raise RuntimeError(f"Checkpointer({self.directory!r}) is "
                               "read-only (serving reader); refusing save")
        self._fence()
        snap = self._snapshot(payload)
        if not self.async_save:
            self._write(int(epoch), snap)
            self._drain_manifests()
            return
        self._writer = threading.Thread(
            target=self._write_in_background, args=(int(epoch), snap),
            daemon=True, name="checkpoint-writer")
        self._writer.start()

    # -- restore -------------------------------------------------------------

    def latest_epoch(self) -> int | None:
        self._fence()
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def kept_epochs(self) -> set[int]:
        self._fence()
        return set(self._epochs())

    def _load(self, epoch: int, map_location) -> Any:
        return torch.load(os.path.join(self._step_dir(epoch), PAYLOAD_FILE),
                          map_location=map_location, weights_only=True)

    def restore(self, epoch: int | None = None,
                map_location: str | torch.device = "cpu") -> Any:
        """The payload of ``epoch`` (default: the latest), its tensors on
        ``map_location``.  Transient read errors are retried; a corrupt
        file raises at once."""
        self._fence()
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return self._retry.call(self._load, int(epoch), map_location,
                                site="checkpoint/restore")

    def saved_digest(self, epoch: int) -> str | None:
        """The :func:`state_digest` taken of epoch's payload at save."""
        try:
            with open(os.path.join(self._step_dir(epoch), DIGEST_FILE)) as f:
                return f.read().strip() or None
        except FileNotFoundError:
            return None

    def quarantine_epoch(self, epoch: int) -> str | None:
        """Move a proven-corrupt epoch (and its manifest) to
        ``quarantine/<epoch>`` (``.1``, ``.2``, ... when taken), so the
        resumed run's save of it writes afresh and no later manifest
        re-blesses the files.  Returns the new path; None when there was
        nothing to move, or in read-only mode (only the writer moves its
        files)."""
        if self.read_only:
            return None
        step_dir = recovery.find_step_dir(self.directory, epoch)
        if step_dir is None:
            return None
        qdir = os.path.join(self.directory, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, str(int(epoch)))
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(qdir, f"{int(epoch)}.{n}")
        os.rename(step_dir, dst)
        try:
            os.unlink(recovery.manifest_path(self.directory, epoch))
        except OSError:
            pass
        return dst

    def restore_latest_verified(self, map_location: str | torch.device = "cpu"
                                ) -> tuple[int | None, Any]:
        """(epoch, payload) of the newest checkpoint that verifies
        against its manifest and restores, falling back past corrupt
        ones (resilience/recovery.py); (None, None) when none does."""
        self._fence()
        self._drain_manifests()
        return recovery.restore_latest_verified(self,
                                                map_location=map_location)

    def close(self) -> None:
        # a failed final write is data loss: the fence raises it, chained
        # to whatever exception is unwinding when close runs in a finally
        self._fence()
        self._drain_manifests()
        if (self._manifest_thread is not None
                and self._manifest_thread.is_alive()):
            self._manifest_q.put(None)
            self._manifest_thread.join(timeout=5)
        if not self.read_only:
            # a digest that raced the pruning of its epoch left a manifest
            recovery.prune_manifests(self.directory, set(self._epochs()))


def _without_zip_crc32():
    """``torch.save`` without the per-record CRC-32 of its zip container
    (``Checkpointer`` docstring)."""
    from torch.utils.serialization import config

    return config.patch({"save.compute_crc32": False})


class _Slot:
    """Where the ``i``-th tensor of a payload goes in its snapshot."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _truncate_largest_file(step_dir: str) -> None:
    """Fault-plane helper: halve the largest file of a step directory
    (a checkpoint write that landed corrupt)."""
    best, best_size = None, -1
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            full = os.path.join(root, name)
            size = os.path.getsize(full)
            if size > best_size:
                best, best_size = full, size
    if best is not None and best_size > 0:
        with open(best, "r+b") as f:
            f.truncate(best_size // 2)
