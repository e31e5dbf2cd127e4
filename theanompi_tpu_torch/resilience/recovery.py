"""Checkpoint integrity and verified restore (copy of
``theanompi_tpu/resilience/recovery.py``).

* **manifest**: after a version's or an epoch's files are written,
  ``manifest_{n}.json`` beside its directory records each file's size
  and sha256 (:func:`write_manifest`); manifests are pruned with the
  checkpoints ``max_to_keep`` drops (:func:`prune_manifests`).
* **verify**: :func:`verify_checkpoint` recomputes them.  A directory
  without a manifest is unverifiable (None), not corrupt: the restore
  itself is then the arbiter.
* **fallback**: :func:`restore_latest_verified` walks the kept epochs
  newest first, quarantines one proven corrupt, skips one whose restore
  raises, and returns the first that loads, so a truncated latest
  checkpoint costs one epoch, not the resume.
* **crash marker**: :func:`record_crash`, the rule session's postmortem
  hook, drops ``resilience_crash_{pid}.json`` into the monitor run dir:
  the rule, the error and the newest manifested epoch, the resume hint
  for the launcher's ``--max-restarts`` or an operator.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import sys
import time

from theanompi_tpu_torch import monitor

_CHUNK = 1 << 20


def manifest_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"manifest_{int(epoch)}.json")


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(step_dir: str) -> dict[str, str]:
    out = {}
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            full = os.path.join(root, name)
            out[os.path.relpath(full, step_dir)] = full
    return out


def write_manifest(directory: str, epoch: int, step_dir: str) -> str:
    """Digest every file under ``step_dir`` into ``manifest_{epoch}.json``
    (atomic rename: a crash never leaves a half-written manifest)."""
    files = {rel: {"size": os.path.getsize(full), "sha256": _digest(full)}
             for rel, full in sorted(_walk_files(step_dir).items())}
    path = manifest_path(directory, epoch)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": int(epoch), "written": time.time(),
                   "n_files": len(files), "files": files}, f)
    os.replace(tmp, path)
    return path


def find_step_dir(directory: str, epoch: int) -> str | None:
    cand = os.path.join(directory, str(int(epoch)))
    return cand if os.path.isdir(cand) else None


def verify_checkpoint(directory: str, epoch: int,
                      step_dir: str | None = None
                      ) -> tuple[bool | None, str]:
    """(ok, detail): True = verified, False = corrupt (first mismatch in
    ``detail``), None = no manifest to verify against."""
    mpath = manifest_path(directory, epoch)
    if not os.path.exists(mpath):
        return None, "no manifest"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    step_dir = step_dir or find_step_dir(directory, epoch)
    if step_dir is None:
        return False, f"step dir missing for epoch {epoch}"
    on_disk = _walk_files(step_dir)
    for rel, want in manifest.get("files", {}).items():
        full = on_disk.get(rel)
        if full is None:
            return False, f"missing file: {rel}"
        size = os.path.getsize(full)
        if size != want["size"]:
            return False, f"size mismatch {rel}: {size} != {want['size']}"
        if _digest(full) != want["sha256"]:
            return False, f"digest mismatch: {rel}"
    return True, f"{manifest.get('n_files', 0)} files verified"


def _manifest_epochs(directory: str) -> list[int]:
    out = []
    for path in glob.glob(os.path.join(directory, "manifest_*.json")):
        m = re.search(r"manifest_(\d+)\.json$", path)
        if m:
            out.append(int(m.group(1)))
    return out


def prune_manifests(directory: str, kept_epochs: set[int]) -> None:
    """Drop the manifests of epochs that ``max_to_keep`` pruned."""
    for epoch in _manifest_epochs(directory):
        if epoch not in kept_epochs:
            try:
                os.unlink(manifest_path(directory, epoch))
            except OSError:
                pass


def restore_latest_verified(ckpt, **restore_kwargs):
    """(epoch, payload) of the newest checkpoint that verifies and
    restores; (None, None) when nothing is restorable.  ``ckpt`` is a
    ``utils.checkpoint.Checkpointer`` (``kept_epochs``, ``directory``,
    ``restore``, ``quarantine_epoch``); ``restore_kwargs`` go to its
    ``restore``."""
    epochs = sorted(ckpt.kept_epochs(), reverse=True)
    for i, epoch in enumerate(epochs):
        ok, detail = verify_checkpoint(ckpt.directory, epoch)
        if ok is False:
            monitor.inc("resilience/checkpoint_corrupt_total")
            # proven corrupt: move it aside so the resumed run's save of
            # this epoch writes afresh and nothing re-blesses the files.
            # A restore that raises (below) is not quarantined: without
            # a digest proof it may be transient.
            quarantined = None
            try:
                quarantined = ckpt.quarantine_epoch(epoch)
            except OSError:
                pass
            where = ("quarantined to " + quarantined if quarantined
                     else "left in place")
            print(f"[resilience] checkpoint epoch {epoch} in "
                  f"{ckpt.directory} is CORRUPT ({detail}); {where}; "
                  "trying the previous kept epoch", file=sys.stderr,
                  flush=True)
            continue
        try:
            payload = ckpt.restore(epoch, **restore_kwargs)
        except Exception as e:
            # no manifest and unloadable, or a corruption the manifest
            # missed: the same fallback
            monitor.inc("resilience/checkpoint_corrupt_total")
            print(f"[resilience] checkpoint epoch {epoch} in "
                  f"{ckpt.directory} failed to restore "
                  f"({type(e).__name__}: {e}); trying the previous kept "
                  "epoch", file=sys.stderr, flush=True)
            continue
        if i > 0:
            monitor.inc("resilience/checkpoint_fallbacks_total")
            print(f"[resilience] resumed from FALLBACK epoch {epoch} "
                  f"(skipped {i} corrupt/unloadable)", file=sys.stderr,
                  flush=True)
        return epoch, payload
    return None, None


def latest_manifest_epoch(directory: str) -> int | None:
    """Newest epoch with a manifest on disk: the digest-free resume hint
    of :func:`record_crash` (the resume verifies in full)."""
    return max(_manifest_epochs(directory), default=None)


def record_crash(rule_name: str, exc: BaseException,
                 model=None) -> str | None:
    """The rule session's postmortem hook (rules/base.py): a crash marker
    with a resume hint in the monitor run dir.  Never raises; a no-op
    when monitoring is off."""
    run_dir = monitor.monitor_dir()
    if not monitor.enabled() or run_dir is None:
        return None
    try:
        marker = {"rule": rule_name,
                  "error": f"{type(exc).__name__}: {exc}",
                  "time": time.time()}
        if model is not None:
            ckpt_dir = os.path.join(model.config.snapshot_dir, model.name)
            marker["checkpoint_dir"] = os.path.abspath(ckpt_dir)
            marker["latest_manifest_epoch"] = (
                latest_manifest_epoch(ckpt_dir)
                if os.path.isdir(ckpt_dir) else None)
        path = os.path.join(run_dir, f"resilience_crash_{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(marker, f)
        return path
    except Exception:
        return None  # a crash marker must never mask the crash
