"""What the port's bench tools share: where they write, a free port, the
``--device`` flag and the monitor JSONL readers their gates use."""

from __future__ import annotations

import contextlib
import json
import os
import socket

import torch

#: the checkout's root (the tools write under its ``build/``)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_path(*parts: str) -> str:
    """A path under the checkout's ``build/`` (listed in .gitignore)."""
    return os.path.join(REPO, "build", *parts)


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the block, restoring them after."""
    prior = {k: os.environ.get(k) for k in values}
    try:
        os.environ.update(values)
        yield
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tensors and the stores live: cuda "
                         "(default; raises without a card) or cpu")


def sync(device) -> None:
    """Wait for the card's queued work (a fence around a timed stage);
    nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def jsonl_records(path: str | None) -> list[dict]:
    """The records of a monitor snapshot JSONL (none when it is absent)."""
    if not path or not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def span_labels(records: list[dict], span: str, label: str) -> set:
    """The values of ``label`` on the ``span_ms`` series of ``span`` (the
    port's registry names it in the ``span`` label) that counted at least
    one span."""
    return {r.get("labels", {}).get(label) for r in records
            if r.get("name") == "span_ms"
            and r.get("labels", {}).get("span") == span
            and r.get("count", 0) > 0}


def shm_evidence(monitor_dir: str | None, since: float = 0.0) -> dict:
    """Shared-memory-lane evidence over every metrics JSONL in
    ``monitor_dir`` written after ``since``: child processes (readers,
    shards) write their own files beside the caller's, so both sides of
    the lane show.  Snapshots are cumulative: per (file, series) the last
    value counts."""
    grants = oob = 0.0
    if not monitor_dir or not os.path.isdir(monitor_dir):
        return {"grants": 0, "oob_bytes": 0}
    for fn in sorted(os.listdir(monitor_dir)):
        path = os.path.join(monitor_dir, fn)
        if not fn.endswith(".jsonl") or os.path.getmtime(path) < since:
            continue
        last: dict[str, float] = {}
        for rec in jsonl_records(path):
            name = rec.get("name")
            if name in ("shm/grants_total", "shm/oob_bytes_total"):
                key = f"{name}|{sorted((rec.get('labels') or {}).items())}"
                last[key] = float(rec.get("value") or 0.0)
        for key, v in last.items():
            if key.startswith("shm/grants_total"):
                grants += v
            else:
                oob += v
    return {"grants": int(grants), "oob_bytes": int(oob)}


def write_json(path: str, doc: dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path
