"""Integrity manifests for exports (subset of ``theanompi_tpu/
resilience/recovery.py``).

After a version's files are written, ``manifest_{v}.json`` beside its
directory records each file's size and sha256; :func:`verify_checkpoint`
recomputes them.  A version without a manifest is unverifiable (None),
not corrupt.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

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
