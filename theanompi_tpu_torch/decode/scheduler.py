"""ContinuousBatcher — iteration-level scheduling for token decode.

Counterpart of ``theanompi_tpu/decode/scheduler.py``, with the same
policy, admission, coalescing, plain and speculative steps,
copy-on-write accounting, drain/migrate, eviction and failure paths,
the same ``decode_step`` and ``page_migrate`` fault sites and the same
``decode/*`` monitor series.  A step failure cannot consume the pool
here (there is no buffer donation), but the replica still restarts on
zeroed pages, as the JAX package does.

``serving/batcher.py`` coalesces REQUESTS: a batch forms, runs once,
and every member completes together.  Token generation breaks that
shape — sequences finish at different lengths, and a per-request batch
would hold 1-token stragglers hostage to 64-token neighbors.  This
scheduler batches ITERATIONS instead (the continuous-batching
discipline): between any two decode steps it may **admit** pending
prompts into free cache slots and **evict** finished sequences, so a
request admitted mid-stream shares its very first decode step with
whatever is already in flight (pinned by tests/test_decode.py and the
preflight decode smoke) and an evicted slot is refilled without
draining the batch.

What carries over from ``DynamicBatcher`` unchanged:

* **typed O(1) admission** — a full pending queue raises
  :class:`~theanompi_tpu_torch.serving.batcher.Overloaded` immediately (the
  same class, so it rides the wire's ``err`` prefix identically);
* **deadline-from-oldest** — here the oldest pending prompt's wait is
  bounded by ONE decode step + its prefill, because admission runs
  every iteration rather than at batch boundaries;
* the **dead-replica contract** — a step failure hands the exception
  to ``on_error``; a falsy return marks the batcher dead, pending and
  future submits get ``Overloaded``, and the server routes around the
  corpse (``DecodeReplica`` owns restart-from-export, exactly like
  ``Replica``).

With a **draft session** (speculative decoding, docs/SERVING.md), the
per-iteration step becomes a ROUND: one draft ``propose`` call (k
greedy proposals), one bucketed target ``verify`` step (accept the
longest matching prefix, k+1 tokens on a full accept), one draft
``commit`` — still iteration-level, so admits/evicts interleave with
speculative rounds exactly as with plain steps, and a draft that
cannot be reloaded after a fault downgrades the replica to plain
decode instead of costing availability.

Telemetry: per-token inter-token latency (``decode/intertoken_ms`` —
the serving SLO, not request latency), tokens/steps counters, active/
pending gauges, cache occupancy and evictions, speculative accept
rate (``decode/accept_rate``, drafted/accepted counters) and
prefix-cache hit/miss/eviction + copy-on-write counters — all in the
monitor registry (docs/OBSERVABILITY.md) plus a host-side p50/p99
ring in ``stats()`` for the bench tools.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock
from theanompi_tpu_torch.decode.migrate import (
    IncompatiblePages,
    pages_incompatibility,
)
from theanompi_tpu_torch.monitor import trace
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving.batcher import Overloaded


@dataclasses.dataclass(frozen=True)
class DecodePolicy:
    """Admission/generation knobs for one decode replica."""

    #: admission bound: pending PROMPTS beyond this are rejected with
    #: Overloaded instead of queued (docs/SERVING.md overload
    #: semantics)
    max_pending: int = 32
    #: server-side cap on tokens generated per request
    max_new_cap: int = 256
    #: a blocked generate() gives up after this long
    submit_timeout_s: float = 120.0
    #: greedy decode stops early on this token (None = length-only)
    eos_token: int | None = None
    #: draft tokens per speculative round (used only when the replica
    #: has a draft session; k drafts verify in ONE target step and the
    #: verify's own argmax rides along, so a full accept advances a
    #: stream k+1 tokens per step — docs/SERVING.md "Speculative
    #: decode")
    speculate_k: int = 4
    #: max prompts coalesced into ONE batched prefill per admission
    #: round (``DecodeSession.admit_batch``); 1 = the pre-batching
    #: serial path, one prefill program call per prompt
    prefill_batch: int = 8
    #: how long the OLDEST pending prompt may wait for company before
    #: its batch launches regardless of occupancy — DynamicBatcher's
    #: deadline-from-oldest, applied to admission (docs/SERVING.md
    #: "Batched prefill")
    prefill_delay_ms: float = 2.0


class MigratedStream:
    """Returned (never raised) by generate/generate_adopted when the
    replica DRAINED mid-stream (scale-down page re-migration,
    docs/SERVING.md): ``tokens`` are the already-emitted tokens MINUS
    the pending one, which travels as the manifest's ``first_token`` —
    the router stitches ``tokens + survivor_output`` for a result
    byte-identical to an undrained run."""

    __slots__ = ("tokens", "manifest", "k", "v")

    def __init__(self, tokens: list[int], manifest: dict, k, v):
        self.tokens = tokens
        self.manifest = manifest
        self.k = k
        self.v = v


class _GenRequest:
    __slots__ = ("prompt", "max_new", "out", "done", "error", "t0",
                 "t_last", "cancelled", "adopted", "migrated")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 adopted: tuple | None = None):
        self.prompt = prompt
        self.max_new = int(max_new)
        #: page migration (decode/migrate.py): ``(manifest, k, v)``
        #: when this stream was prefilled elsewhere — admission adopts
        #: the pages instead of running a local prefill
        self.adopted = adopted
        #: set by the drain path: this stream left as pages, the
        #: parked caller returns the payload instead of tokens
        self.migrated: MigratedStream | None = None
        self.out: list[int] = []
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.t0 = time.monotonic()
        self.t_last = self.t0
        #: set by an abandoning client thread, read by the scheduler at
        #: the next step boundary — a benign boolean race (either the
        #: scheduler sees it this step or the next)
        self.cancelled = False


class ContinuousBatcher:
    """One decode replica's scheduler thread + admission queue.

    ``session`` is a :class:`~theanompi_tpu_torch.decode.session.DecodeSession`;
    its cache state is owned by THIS object's single scheduler thread.
    ``generate`` is the client-side entry (any thread)."""

    def __init__(self, session, policy: DecodePolicy | None = None,
                 replica: int = 0, on_error=None, draft_session=None):
        self.session = session
        self.policy = policy or DecodePolicy()
        self.replica = int(replica)
        self._on_error = on_error
        #: draft DecodeSession (speculative decoding) or None; owned
        #: by the scheduler thread like the target session — a restart
        #: that cannot reload the draft clears it (speculation off,
        #: replica keeps serving)
        self._draft = draft_session
        if draft_session is not None:
            k = int(self.policy.speculate_k)
            for s, who in ((session, "target"), (draft_session, "draft")):
                if not 1 <= k <= s.window - 1:
                    raise ValueError(
                        f"speculate_k {k} outside [1, window-1="
                        f"{s.window - 1}] for the {who} session")
        self._pending: deque[_GenRequest] = deque()  # guarded_by: self._lock
        self._lock = make_lock("ContinuousBatcher._lock")
        self._cond = make_condition(self._lock)
        self._dead = False                           # guarded_by: self._lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # scheduler-thread-owned live set:
        # (request, target _Seq, draft _Seq | None)
        self._active: list[tuple[_GenRequest, object, object]] = []
        self._steps = 0
        # plain-int stats (torn reads of monotonic ints are harmless
        # for stats(), the DynamicBatcher convention)
        self.n_tokens = 0
        self.n_steps = 0
        self.n_admitted = 0
        self.n_evicted = 0
        self.n_overloaded = 0
        self.n_step_errors = 0
        #: steps whose decode batch held >= 2 sequences — the
        #: iteration-level-sharing proof the preflight smoke asserts
        self.shared_steps = 0
        self.max_concurrent = 0
        #: speculative accounting (utils/token_accounting.py): drafted
        #: = k per sequence per round, accepted = those the verify
        #: step kept; emitted tokens ride the ordinary token counters
        self.n_drafted = 0
        self.n_draft_accepted = 0
        #: page migration (disaggregated serving): streams whose
        #: prefill arrived as wire frames / typed-refused manifests
        self.n_adopted = 0
        self.n_adopt_refused = 0
        #: batched prefill accounting: admission rounds that ran ONE
        #: program call over >= 1 prompts, the largest such batch, and
        #: prompt-token/wall-second totals (the bench's aggregate
        #: prefill-throughput axis)
        self.n_prefill_batches = 0
        self.max_prefill_batch = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        #: scale-down page re-migration: live streams exported as
        #: MigratedStream payloads by drain_migrate()
        self.n_migrated_out = 0
        #: set by drain_migrate(); terminal — admission refuses, the
        #: scheduler exports live streams at the next step boundary
        self._draining = False
        #: next coalescing deadline while admission holds a partial
        #: batch for company (read by _loop for its wait bound)
        self._admit_deadline = 0.0
        #: last-seen cow_copies across both sessions (delta -> monitor)
        self._cow_seen = 0
        self._intertoken_ms: deque[float] = deque(maxlen=4096)  # guarded_by: self._lock
        self._ttft_ms: deque[float] = deque(maxlen=4096)  # guarded_by: self._lock

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ContinuousBatcher":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"decode-scheduler-{self.replica}")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._fail_pending(Overloaded(
            f"decode replica {self.replica} is shutting down"))

    @property
    def alive(self) -> bool:
        with self._lock:
            return not self._dead and not self._stop.is_set()

    def reset_intertoken(self) -> None:
        """Drop the inter-token AND time-to-first-token latency rings
        (bench seam: a warm pass runs each bucket first, and those
        multi-second gaps would otherwise sit in the measured pass's
        p99)."""
        with self._lock:
            self._intertoken_ms.clear()
            self._ttft_ms.clear()

    def stats(self) -> dict:
        from theanompi_tpu_torch.utils.token_accounting import (
            speculative_accounting,
        )

        with self._lock:
            pending = len(self._pending)
            lat = (np.sort(np.asarray(self._intertoken_ms, np.float64))
                   if self._intertoken_ms else np.zeros((0,)))
            ttft = (np.sort(np.asarray(self._ttft_ms, np.float64))
                    if self._ttft_ms else np.zeros((0,)))

        def _pcts(a):
            def pk(q):
                return (float(a[min(len(a) - 1, int(q * len(a)))])
                        if len(a) else None)
            return {"p50": pk(0.50), "p99": pk(0.99), "count": len(a)}
        pc = self.session.prefix_cache
        # one-read snapshot: disable_speculation() nulls _draft on the
        # scheduler thread while stats() runs on an RPC handler thread
        draft = self._draft
        return {
            "replica": self.replica,
            "alive": self.alive,
            "tokens": self.n_tokens,
            "steps": self.n_steps,
            "admitted": self.n_admitted,
            "evicted": self.n_evicted,
            "overloaded": self.n_overloaded,
            "step_errors": self.n_step_errors,
            "shared_steps": self.shared_steps,
            "max_concurrent": self.max_concurrent,
            "adopted": self.n_adopted,
            "adopt_refused": self.n_adopt_refused,
            "active": len(self._active),
            "pending": pending,
            "free_pages": self.session.pool.free_pages,
            "intertoken_ms": _pcts(lat),
            "ttft_ms": _pcts(ttft),
            "prefill_batches": self.n_prefill_batches,
            "max_prefill_batch": self.max_prefill_batch,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "drain_migrated": self.n_migrated_out,
            "draining": self._draining,
            "compiles": dict(self.session.compiles),
            "draft_compiles": (dict(draft.compiles)
                               if draft is not None else None),
            "speculative": draft is not None,
            # one arithmetic with bench_lm/bench_serving: emitted
            # tokens are the throughput axis; rejected drafts are
            # compute, not output
            "speculation": speculative_accounting(
                self.n_tokens, self.n_drafted, self.n_draft_accepted),
            "prefix_cache": (None if pc is None else {
                "hits": pc.hits, "misses": pc.misses,
                "evictions": pc.evictions, "entries": len(pc),
                "cached_pages": pc.cached_pages,
            }),
            "cow_copies": (self.session.cow_copies
                           + (draft.cow_copies
                              if draft is not None else 0)),
        }

    # -- client side ----------------------------------------------------

    def generate(self, prompt, max_new: int | None = None):
        """Greedy-decode up to ``max_new`` tokens after ``prompt``;
        blocks until the sequence finishes and returns the token list.
        Raises :class:`Overloaded` on admission rejection or re-raises
        the step error that consumed this request.  If the replica
        drained mid-stream (scale-down), returns a
        :class:`MigratedStream` instead of tokens."""
        if trace.enabled():
            # under tracing, a GENERATE handled via rpc_handle (the
            # serving plane) gets a decode-side child span here — the
            # client -> server -> replica -> batcher chain closes at
            # the batcher.  Gated so the untraced hot path (and its
            # metric stream) is unchanged.
            with monitor.span("decode_generate", replica=self.replica):
                return self._generate(prompt, max_new)
        return self._generate(prompt, max_new)

    def _generate(self, prompt, max_new: int | None = None):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = int(max_new if max_new is not None
                      else self.policy.max_new_cap)
        max_new = min(max_new, self.policy.max_new_cap)
        if prompt.shape[0] < 1 or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if prompt.shape[0] > self.session.max_prompt:
            raise ValueError(
                f"prompt length {prompt.shape[0]} exceeds the largest "
                f"prefill bucket {self.session.max_prompt}")
        if prompt.shape[0] + max_new > self.session.max_len:
            raise ValueError(
                f"prompt+max_new {prompt.shape[0] + max_new} exceeds "
                f"the model's max_len {self.session.max_len} "
                "(positional table)")
        req = _GenRequest(prompt, max_new)
        with self._cond:
            if self._dead or self._draining or self._stop.is_set():
                self.n_overloaded += 1
                monitor.inc("decode/overloaded_total",
                            replica=self.replica)
                raise Overloaded(
                    f"decode replica {self.replica} is not serving"
                    + (" (draining)" if self._draining else ""))
            if len(self._pending) >= self.policy.max_pending:
                self.n_overloaded += 1
                monitor.inc("decode/overloaded_total",
                            replica=self.replica)
                raise Overloaded(
                    f"decode replica {self.replica} admission queue is "
                    f"full ({self.policy.max_pending} pending); "
                    "rejecting instead of queueing unboundedly")
            self._pending.append(req)
            monitor.set_gauge("decode/pending", len(self._pending),
                              replica=self.replica)
            self._cond.notify_all()
        if not req.done.wait(self.policy.submit_timeout_s):
            with self._cond:
                try:
                    self._pending.remove(req)
                except ValueError:
                    # already admitted: the scheduler evicts it at the
                    # next step boundary via the cancelled flag
                    req.cancelled = True
            raise TimeoutError(
                f"generate timed out after "
                f"{self.policy.submit_timeout_s}s on decode replica "
                f"{self.replica}")
        if req.error is not None:
            raise req.error
        if req.migrated is not None:
            # the replica drained mid-stream: hand the partial output
            # + exported pages up for the router to re-dispatch
            return req.migrated
        return req.out

    def generate_adopted(self, manifest: dict, k, v,
                         max_new: int | None = None):
        """Adopt a migrated prefill (decode/migrate.py) and greedy-
        decode up to ``max_new`` further tokens.  The manifest's
        ``first_token`` (the sender's prefill argmax) is emitted as
        token 0, so the stream's output is byte-identical to
        :meth:`generate` over the same prompt on one replica.  Raises
        the typed :class:`IncompatiblePages` when the pages don't fit
        this replica's pool — a per-stream refusal, the replica and
        the connection keep serving — and :class:`Overloaded` on
        admission rejection, exactly like :meth:`generate`."""
        if trace.enabled():
            with monitor.span("decode_generate", replica=self.replica):
                return self._generate_adopted(manifest, k, v, max_new)
        return self._generate_adopted(manifest, k, v, max_new)

    def _generate_adopted(self, manifest, k, v,
                          max_new: int | None = None):
        faults.fire("page_migrate", side="adopt", replica=self.replica)
        # geometry refusal BEFORE enqueue: a stream that can never be
        # adopted must not occupy a pending slot (O(1), no data copy)
        reason = pages_incompatibility(manifest, k, v,
                                       self.session.cfg)
        if reason is not None:
            self.n_adopt_refused += 1
            monitor.inc("decode/adopt_refused_total",
                        replica=self.replica)
            raise IncompatiblePages(reason)
        max_new = int(max_new if max_new is not None
                      else self.policy.max_new_cap)
        max_new = min(max_new, self.policy.max_new_cap)
        if max_new < 1:
            raise ValueError("need max_new >= 1")
        length = int(manifest["length"])
        if length + max_new > self.session.max_len:
            raise ValueError(
                f"adopted length+max_new {length + max_new} exceeds "
                f"the model's max_len {self.session.max_len} "
                "(positional table)")
        prompt = np.asarray(manifest["prompt"], np.int32).reshape(-1)
        req = _GenRequest(prompt, max_new, adopted=(manifest, k, v))
        with self._cond:
            if self._dead or self._draining or self._stop.is_set():
                self.n_overloaded += 1
                monitor.inc("decode/overloaded_total",
                            replica=self.replica)
                raise Overloaded(
                    f"decode replica {self.replica} is not serving"
                    + (" (draining)" if self._draining else ""))
            if len(self._pending) >= self.policy.max_pending:
                self.n_overloaded += 1
                monitor.inc("decode/overloaded_total",
                            replica=self.replica)
                raise Overloaded(
                    f"decode replica {self.replica} admission queue is "
                    f"full ({self.policy.max_pending} pending); "
                    "rejecting instead of queueing unboundedly")
            self._pending.append(req)
            monitor.set_gauge("decode/pending", len(self._pending),
                              replica=self.replica)
            self._cond.notify_all()
        if not req.done.wait(self.policy.submit_timeout_s):
            with self._cond:
                try:
                    self._pending.remove(req)
                except ValueError:
                    req.cancelled = True
            raise TimeoutError(
                f"generate_adopted timed out after "
                f"{self.policy.submit_timeout_s}s on decode replica "
                f"{self.replica}")
        if req.error is not None:
            raise req.error
        if req.migrated is not None:
            # the replica drained mid-stream: hand the partial output
            # + exported pages up for the router to re-dispatch
            return req.migrated
        return req.out

    # -- scheduler thread ----------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._draining:
                self._migrate_out()
            else:
                self._admit()
            if not self._active:
                with self._cond:
                    if self._stop.is_set():
                        continue
                    if not self._pending:
                        self._cond.wait(0.25)
                        monitor.set_gauge("serving/replica_heartbeat",
                                          time.time(),
                                          replica=self.replica)
                    else:
                        # pending held back by the coalescing deadline
                        # — sleep only until it expires (an arrival
                        # notifies and may fill the batch early); the
                        # floor guards the can't-admit-yet edge
                        remaining = (self._admit_deadline
                                     - time.monotonic())
                        self._cond.wait(min(0.25, max(remaining,
                                                      0.002)))
                continue
            self._step()
        self._drain()

    def _take_pending(self) -> _GenRequest | None:
        with self._cond:
            req = self._pending.popleft() if self._pending else None
            monitor.set_gauge("decode/pending", len(self._pending),
                              replica=self.replica)
            return req

    def _prefix_metrics(self) -> tuple[int, int, int]:
        pc = self.session.prefix_cache
        return (0, 0, 0) if pc is None else (pc.hits, pc.misses,
                                             pc.evictions)

    def _admit(self) -> None:
        """Admit pending prompts into free slots — every iteration, so
        the oldest waiter's deadline is one decode step away.  With
        ``prefill_batch > 1`` an admission round GATHERS up to that
        many plain prompts and runs them as ONE
        :meth:`~theanompi_tpu_torch.decode.session.DecodeSession.admit_batch`
        program call (adopted streams still admit singly — their pages
        scatter, there is no prefill to batch).  With a draft session
        the prompts are admitted into BOTH caches (same geometry, so a
        target admit implies draft capacity)."""
        pb = max(1, int(self.policy.prefill_batch))
        while not self._stop.is_set():
            if pb > 1 and self._hold_for_coalescing(pb):
                break
            batch: list[_GenRequest] = []
            adopted_req: _GenRequest | None = None
            while (len(self._active) + len(batch)
                       < self.session.cfg.max_seqs
                   and len(batch) < pb
                   and self.session.can_admit(len(batch) + 1)
                   and (self._draft is None
                        or self._draft.can_admit(len(batch) + 1))
                   and not self._stop.is_set()):
                req = self._take_pending()
                if req is None:
                    break
                if req.cancelled:
                    continue
                if req.adopted is not None:
                    # adopted streams admit singly: flush the gathered
                    # batch first so arrival order is preserved
                    adopted_req = req
                    break
                if self._shares_page_prefix(req, batch):
                    # a same-round row cannot hit a prefix an earlier
                    # row is about to register (inserts land after the
                    # program runs): defer ONE round so it admits as a
                    # cache hit sharing pages instead of refilling them
                    with self._cond:
                        self._pending.appendleft(req)
                    break
                batch.append(req)
            if batch and not self._admit_plain(batch):
                return
            if adopted_req is not None:
                if not self._admit_adopted(adopted_req):
                    return
                continue
            if not batch:
                break
        monitor.set_gauge("decode/cache_occupancy",
                          self.session.pool.used_fraction,
                          replica=self.replica)
        monitor.set_gauge("decode/active_seqs", len(self._active),
                          replica=self.replica)

    def _shares_page_prefix(self, req: _GenRequest, batch) -> bool:
        """True when ``req`` shares a >= 1-page aligned prompt prefix
        with a row already gathered this round — the page-sharing
        deferral above (no effect with the prefix cache off)."""
        if self.session.prefix_cache is None or not batch:
            return False
        ps = int(self.session.cfg.page_size)
        for r in batch:
            a, b = r.prompt, req.prompt
            n = min(int(a.shape[0]), int(b.shape[0]))
            if n < ps:
                continue
            eq = a[:n] == b[:n]
            m = n if eq.all() else int(np.argmin(eq))
            if m >= ps:
                return True
        return False

    def _hold_for_coalescing(self, pb: int) -> bool:
        """DynamicBatcher's deadline-from-oldest applied to admission:
        while the OLDEST pending prompt is younger than
        ``prefill_delay_ms`` and more batchable room remains, hold off
        so a burst coalesces into one prefill program call instead of
        several small ones.  Never holds an adopted stream (no prefill
        to batch), a full batch, or past the deadline — the delay
        bounds added time-to-first-token exactly."""
        delay_s = float(self.policy.prefill_delay_ms) / 1e3
        if delay_s <= 0:
            return False
        with self._lock:
            n = len(self._pending)
            if n == 0 or self._pending[0].adopted is not None:
                return False
            oldest_t0 = self._pending[0].t0
        room = min(pb,
                   self.session.cfg.max_seqs - len(self._active))
        if n >= room:
            return False
        deadline = oldest_t0 + delay_s
        if time.monotonic() >= deadline:
            return False
        self._admit_deadline = deadline
        return True

    def _admit_plain(self, batch: list[_GenRequest]) -> bool:
        """One admission round: N prompts -> ONE batched prefill
        program call (``prefill_batch == 1`` keeps the pre-batching
        serial ``admit`` path, byte-for-byte — the bench's comparison
        leg).  Returns False only when the poisoned-device path ran
        (``_abort_inflight``), mirroring ``_admit_adopted``."""
        serial = max(1, int(self.policy.prefill_batch)) == 1
        t0 = time.monotonic()
        h0, m0, e0 = self._prefix_metrics()
        try:
            if serial:
                admitted = [self.session.admit(batch[0].prompt)]
            else:
                admitted = self.session.admit_batch(
                    [r.prompt for r in batch])
        except Exception as e:
            if isinstance(e, ValueError):
                # a bad request must not kill the replica (lengths
                # were validated at submit, so this is defensive)
                self._fail_requests(batch, e)
                return True
            self._abort_inflight(e, extra=batch)
            return False
        dseqs: list = [None] * len(batch)
        if self._draft is not None:
            try:
                if serial:
                    dseq, _ = self._draft.admit(batch[0].prompt)
                    dseqs = [dseq]
                else:
                    dseqs = [s for s, _ in self._draft.admit_batch(
                        [r.prompt for r in batch])]
            except Exception as e:
                for seq, _ in admitted:
                    self.session.release(seq)
                if isinstance(e, ValueError):
                    self._fail_requests(batch, e)
                    return True
                self._abort_inflight(e, extra=batch)
                return False
        h1, m1, e1 = self._prefix_metrics()
        if h1 > h0:
            monitor.inc("decode/prefix_cache_hits_total",
                        h1 - h0, replica=self.replica)
        if m1 > m0:
            monitor.inc("decode/prefix_cache_misses_total",
                        m1 - m0, replica=self.replica)
        if e1 > e0:
            monitor.inc("decode/prefix_cache_evictions_total",
                        e1 - e0, replica=self.replica)
        dt = time.monotonic() - t0
        monitor.observe("decode/prefill_ms", dt * 1e3,
                        replica=self.replica)
        monitor.observe("decode/prefill_batch_occupancy",
                        float(len(batch)), replica=self.replica)
        self.n_prefill_batches += 1
        self.max_prefill_batch = max(self.max_prefill_batch,
                                     len(batch))
        self.prefill_tokens += sum(int(r.prompt.shape[0])
                                   for r in batch)
        self.prefill_s += dt
        self.n_admitted += len(batch)
        monitor.inc("decode/admitted_total", float(len(batch)),
                    replica=self.replica)
        for req, (seq, logits), dseq in zip(batch, admitted, dseqs):
            self._active.append((req, seq, dseq))
            self._emit_token(req, int(np.argmax(logits)))
        self.max_concurrent = max(self.max_concurrent,
                                  len(self._active))
        self._evict_finished()
        return True

    # -- scale-down page re-migration ----------------------------------

    def drain_migrate(self) -> None:
        """Scale-down hand-off (any thread): admission starts refusing
        with Overloaded, pending requests fail with it (the router's
        existing failover re-dispatches them), and at the next step
        boundary the scheduler exports every LIVE stream's pages + a
        resume manifest — the parked ``generate`` calls return
        :class:`MigratedStream` payloads for the router to re-dispatch
        onto a survivor, byte-identical.  Terminal: a draining replica
        never resumes admission."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def _migrate_out(self) -> None:
        """Drain leg (scheduler thread, step boundary): every live
        stream leaves as pages + a resume manifest — prompt plus the
        tokens emitted so far, with the PENDING token (emitted to the
        caller but not yet decoded) travelling as the manifest's
        ``first_token``.  The survivor re-emits exactly that token
        first, so the stitched ``tokens + survivor_output`` is
        byte-identical to finishing here."""
        from theanompi_tpu_torch.decode.migrate import page_manifest

        active, self._active = self._active, []
        for req, seq, dseq in active:
            if self._finished(req):
                self.session.release(seq)
                if dseq is not None and self._draft is not None:
                    self._draft.release(dseq)
                self.n_evicted += 1
                monitor.inc("decode/evictions_total",
                            replica=self.replica)
                req.done.set()
                continue
            try:
                k, v = self.session.export_pages(seq)
                # invariant: seq.length == len(prompt) + len(out) - 1
                # for a live stream, so the resume prompt is exactly
                # the attended positions and out[-1] is the pending
                # token the survivor will decode first
                resume = np.concatenate(
                    [req.prompt,
                     np.asarray(req.out[:-1], np.int32)])
                manifest = page_manifest(
                    self.session.cfg, resume, seq.length,
                    int(req.out[-1]), version=self.session.version)
                req.migrated = MigratedStream(
                    [int(t) for t in req.out[:-1]], manifest, k, v)
                self.n_migrated_out += 1
                monitor.inc("decode/drain_migrated_total",
                            replica=self.replica)
            except Exception as e:
                req.error = e
            self.session.release(seq)
            if dseq is not None and self._draft is not None:
                self._draft.release(dseq)
            req.done.set()
        monitor.set_gauge("decode/active_seqs", 0,
                          replica=self.replica)
        self._fail_pending(Overloaded(
            f"decode replica {self.replica} is draining "
            "(scale-down)"))

    def _admit_adopted(self, req: _GenRequest) -> bool:
        """Admission for a migrated stream (decode/migrate.py): the
        shipped pages scatter into the pool instead of running a local
        prefill, and the sender's first token is emitted verbatim.
        Returns False only when the poisoned-device path ran
        (``_abort_inflight``) and the admit loop must stop."""
        manifest, kp, vp = req.adopted
        t0 = time.monotonic()
        try:
            seq = self.session.adopt_pages(manifest, kp, vp)
        except (IncompatiblePages, ValueError) as e:
            # per-stream refusal — the replica (and its connection)
            # keeps serving; geometry was pre-checked at submit, so
            # this only fires on races like a mid-flight hot reload
            self.n_adopt_refused += 1
            monitor.inc("decode/adopt_refused_total",
                        replica=self.replica)
            self._fail_requests([req], e)
            return True
        except Exception as e:
            self._abort_inflight(e, extra=[req])
            return False
        dseq = None
        if self._draft is not None:
            # the draft is small and prefills the prompt locally — the
            # TARGET's prefill is what migration offloads
            try:
                dseq, _ = self._draft.admit(req.prompt)
            except Exception as e:
                self.session.release(seq)
                if isinstance(e, ValueError):
                    self._fail_requests([req], e)
                    return True
                self._abort_inflight(e, extra=[req])
                return False
        monitor.observe("decode/adopt_ms",
                        (time.monotonic() - t0) * 1e3,
                        replica=self.replica)
        self.n_adopted += 1
        monitor.inc("decode/pages_adopted_total",
                    self.session.cfg.pages_per_seq,
                    replica=self.replica)
        self.n_admitted += 1
        monitor.inc("decode/admitted_total", replica=self.replica)
        self._active.append((req, seq, dseq))
        self.max_concurrent = max(self.max_concurrent,
                                  len(self._active))
        self._emit_token(req, int(manifest["first_token"]))
        self._evict_finished()
        return True

    def _step(self) -> None:
        if self._draft is not None:
            self._spec_step()
            return
        self._steps += 1
        t0 = time.monotonic()
        reqs = [r for r, _, _ in self._active]
        seqs = [s for _, s, _ in self._active]
        tokens = np.asarray(
            [r.out[-1] if r.out else int(r.prompt[-1]) for r in reqs],
            np.int32)
        try:
            faults.fire("decode_step", replica=self.replica,
                        step=self._steps)
            logits = self.session.decode(seqs, tokens)
        except Exception as e:
            self._abort_inflight(e)
            return
        self.n_steps += 1
        monitor.inc("decode/steps_total", replica=self.replica)
        monitor.observe("decode/step_ms",
                        (time.monotonic() - t0) * 1e3,
                        replica=self.replica)
        monitor.set_gauge("serving/replica_heartbeat", time.time(),
                          replica=self.replica)
        if len(self._active) >= 2:
            self.shared_steps += 1
        for i, (req, _, _) in enumerate(self._active):
            self._emit_token(req, int(np.argmax(logits[i])))
        self._emit_cow_delta()
        self._evict_finished()

    def _spec_step(self) -> None:
        """One speculative round for every active sequence: k draft
        proposals (one draft program call), ONE bucketed target verify
        step, then the draft cache commits the accepted prefix.  Every
        sequence advances by its accept count + 1 (the verify step's
        own argmax token rides along), so a full accept yields k+1
        tokens for one target step."""
        self._steps += 1
        k = int(self.policy.speculate_k)
        t0 = time.monotonic()
        reqs = [r for r, _, _ in self._active]
        seqs = [s for _, s, _ in self._active]
        dseqs = [d for _, _, d in self._active]
        pending = np.asarray(
            [r.out[-1] if r.out else int(r.prompt[-1]) for r in reqs],
            np.int32)
        try:
            faults.fire("decode_step", replica=self.replica,
                        step=self._steps)
            drafts = self._draft.propose(dseqs, pending, k)
            y, counts = self.session.verify(seqs, pending, drafts)
            self._draft.commit(dseqs, counts)
        except Exception as e:
            self._abort_inflight(e)
            return
        self.n_steps += 1
        monitor.inc("decode/steps_total", replica=self.replica)
        monitor.observe("decode/step_ms",
                        (time.monotonic() - t0) * 1e3,
                        replica=self.replica)
        monitor.set_gauge("serving/replica_heartbeat", time.time(),
                          replica=self.replica)
        if len(self._active) >= 2:
            self.shared_steps += 1
        for i, (req, _, _) in enumerate(self._active):
            accepted = int(counts[i]) - 1
            self.n_drafted += k
            self.n_draft_accepted += accepted
            monitor.inc("decode/draft_tokens_total", k,
                        replica=self.replica)
            if accepted:
                monitor.inc("decode/draft_accepted_total", accepted,
                            replica=self.replica)
            monitor.observe("decode/accept_rate", accepted / k,
                            replica=self.replica)
            for j in range(int(counts[i])):
                if self._finished(req):
                    # max_new / eos reached mid-run: the device wrote
                    # the extra positions' K/V, but the sequence is
                    # evicted below, so the surplus is unobservable —
                    # emitted output stays byte-identical to the
                    # non-speculative oracle
                    break
                self._emit_token(req, int(y[i, j]))
        self._emit_cow_delta()
        self._evict_finished()

    def _emit_cow_delta(self) -> None:
        cow = self.session.cow_copies + (self._draft.cow_copies
                                         if self._draft is not None
                                         else 0)
        if cow > self._cow_seen:
            monitor.inc("decode/cow_copies_total",
                        cow - self._cow_seen, replica=self.replica)
            self._cow_seen = cow

    def disable_speculation(self) -> None:
        """Drop the draft session (restart path when the draft export
        cannot be reloaded): the replica keeps serving, plain decode —
        an accelerator must never cost availability.  Scheduler-thread
        only (like every cache mutation); active draft sequences are
        released."""
        if self._draft is None:
            return
        for _, _, dseq in self._active:
            if dseq is not None:
                self._draft.release(dseq)
        self._active = [(r, s, None) for r, s, _ in self._active]
        self._draft = None
        # the monitor delta tracked target+draft COW as one sum;
        # re-anchor on the target alone or the next (sum < seen)
        # comparisons silently drop real target copies
        self._cow_seen = self.session.cow_copies

    def _emit_token(self, req: _GenRequest, token: int) -> None:
        now = time.monotonic()
        first = not req.out
        req.out.append(token)
        self.n_tokens += 1
        monitor.inc("decode/tokens_total", replica=self.replica)
        if first:
            # the first token is prefill's output: its latency is
            # queue wait + prefill (decode/prefill_ms covers it), not
            # an inter-token gap — recording it would let admission
            # queueing contaminate the SLO histogram under overload.
            # It IS time-to-first-token, the axis batched prefill
            # trades coalescing delay against — tracked separately.
            ttft_ms = (now - req.t0) * 1e3
            with self._lock:
                self._ttft_ms.append(ttft_ms)
            monitor.observe("decode/ttft_ms", ttft_ms,
                            replica=self.replica)
            req.t_last = now
            return
        dt_ms = (now - req.t_last) * 1e3
        req.t_last = now
        with self._lock:  # stats() iterates this deque concurrently
            self._intertoken_ms.append(dt_ms)
        monitor.observe("decode/intertoken_ms", dt_ms,
                        replica=self.replica)

    def _finished(self, req: _GenRequest) -> bool:
        if req.cancelled or len(req.out) >= req.max_new:
            return True
        eos = self.policy.eos_token
        return eos is not None and bool(req.out) and req.out[-1] == eos

    def _evict_finished(self) -> None:
        keep = []
        for req, seq, dseq in self._active:
            if self._finished(req):
                self.session.release(seq)
                if dseq is not None and self._draft is not None:
                    self._draft.release(dseq)
                self.n_evicted += 1
                monitor.inc("decode/evictions_total",
                            replica=self.replica)
                req.done.set()
            else:
                keep.append((req, seq, dseq))
        self._active = keep
        monitor.set_gauge("decode/active_seqs", len(self._active),
                          replica=self.replica)
        monitor.set_gauge("decode/cache_occupancy",
                          self.session.pool.used_fraction,
                          replica=self.replica)

    # -- failure plumbing ----------------------------------------------

    def _abort_inflight(self, err: BaseException,
                        extra: list | None = None) -> None:
        """A prefill/decode failure poisons the replica's device state:
        fail EVERY in-flight stream and return its pages BEFORE the
        on_error hook runs —
        ``DecodeSession.reset_cache``'s precondition — then restart
        from the export or mark the replica dead.  ``extra`` carries a
        request that failed before it owned a sequence (the admit
        path)."""
        self.n_step_errors += 1
        monitor.inc("decode/step_errors_total", replica=self.replica)
        for _, seq, dseq in self._active:
            self.session.release(seq)
            if dseq is not None and self._draft is not None:
                self._draft.release(dseq)
        failed, self._active = [r for r, _, _ in self._active], []
        self._fail_requests(list(extra or ()) + failed, err)
        monitor.set_gauge("decode/active_seqs", 0,
                          replica=self.replica)
        if self._on_error is None or not self._on_error(err):
            self._mark_dead()

    def _fail_requests(self, reqs, err: BaseException) -> None:
        for r in reqs:
            if not r.done.is_set():
                r.error = err
                r.done.set()

    def _mark_dead(self) -> None:
        with self._cond:
            self._dead = True
            self._cond.notify_all()
        self._fail_pending(Overloaded(
            f"decode replica {self.replica} died "
            "(restart budget exhausted)"))

    def _fail_pending(self, err: BaseException) -> None:
        with self._cond:
            pending, self._pending = list(self._pending), deque()
        self._fail_requests(pending, err)

    def _drain(self) -> None:
        """Stop path: evict everything, fail what was still running."""
        err = Overloaded(
            f"decode replica {self.replica} is shutting down")
        for req, seq, dseq in self._active:
            self.session.release(seq)
            if dseq is not None and self._draft is not None:
                self._draft.release(dseq)
            self._fail_requests([req], err)
        self._active = []
        self._fail_pending(err)


class DecodeReplica:
    """One decode session + continuous batcher under the same
    restart-from-export supervision as ``serving/server.py Replica``:
    a step failure fails that step's sequences, then the replica
    reloads VERIFIED bytes from the export (budget ``max_restarts``)
    with a fresh page pool; budget exhausted = replica lost, the
    server routes around it."""

    def __init__(self, idx: int, export_dir: str, model, loaded,
                 policy: DecodePolicy | None = None,
                 max_restarts: int = 2, page_size: int = 16,
                 pages_per_seq: int = 8, max_seqs: int = 8,
                 prefill_buckets: tuple[int, ...] | None = None,
                 draft_export_dir: str | None = None,
                 prefix_cache: bool = True,
                 fleet_cache: str | None = None):
        from theanompi_tpu_torch.decode.session import DecodeSession
        from theanompi_tpu_torch.serving.export import (
            IncompatibleExport,
            build_model_from_meta,
            draft_incompatibility,
            load_export,
        )

        self.idx = int(idx)
        self.export_dir = export_dir
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.session = DecodeSession(
            model, params=loaded.state, version=loaded.version,
            page_size=page_size, pages_per_seq=pages_per_seq,
            max_seqs=max_seqs, prefill_buckets=prefill_buckets,
            prefix_cache=prefix_cache)
        if fleet_cache:
            # fleet-wide prefix cache (decode/fleetcache.py): local
            # misses consult the prefill fleet's authority, cold
            # prefills register their page-aligned prefixes
            from theanompi_tpu_torch.decode.fleetcache import (
                FleetCacheClient,
            )

            self.session.fleet = FleetCacheClient(fleet_cache)
        #: speculative decoding: a second (small) decode-capable
        #: export proposes k tokens per round; same cache geometry so
        #: a target admit implies draft capacity
        self.draft_export_dir = draft_export_dir
        self.draft_session = None
        self.draft_meta = None
        if draft_export_dir:
            dloaded = load_export(draft_export_dir)
            reason = draft_incompatibility(loaded.meta, dloaded.meta)
            if reason is not None:
                raise IncompatibleExport(
                    f"draft export {draft_export_dir} "
                    f"v{dloaded.version}: {reason}")
            dmodel = build_model_from_meta(dloaded.meta, model.device)
            self.draft_session = DecodeSession(
                dmodel, params=dloaded.state, version=dloaded.version,
                page_size=page_size, pages_per_seq=pages_per_seq,
                max_seqs=max_seqs, prefill_buckets=prefill_buckets,
                prefix_cache=prefix_cache)
            self.draft_meta = dloaded.meta
        self.batcher = ContinuousBatcher(
            self.session, policy, replica=self.idx,
            on_error=self._on_step_error,
            draft_session=self.draft_session)

    @property
    def alive(self) -> bool:
        return self.batcher.alive

    def warmup(self) -> None:
        """Run the smallest program of every family this replica can
        reach before the port binds."""
        self.session.warmup()
        if int(self.batcher.policy.prefill_batch) > 1:
            # occupancy varies run to run: every (n_seqs, token)
            # bucket pair runs once up front
            self.session.warmup_prefill_batch()
        if self.draft_session is not None:
            k = int(self.batcher.policy.speculate_k)
            self.session.warmup_spec(k, "target")
            self.draft_session.warmup()
            if int(self.batcher.policy.prefill_batch) > 1:
                self.draft_session.warmup_prefill_batch()
            self.draft_session.warmup_spec(k, "draft")

    def generate(self, prompt, max_new: int | None = None):
        return self.batcher.generate(prompt, max_new)

    def generate_adopted(self, manifest: dict, k, v,
                         max_new: int | None = None):
        return self.batcher.generate_adopted(manifest, k, v, max_new)

    def drain_migrate(self) -> None:
        """Scale-down hand-off: see ContinuousBatcher.drain_migrate."""
        self.batcher.drain_migrate()

    def swap(self, version: int, params, model_state=None) -> None:
        self.session.swap(version, params, model_state)

    def swap_draft(self, version: int, params) -> bool:
        """Hot-swap draft weights (the reload watcher's draft poll);
        monotonic like every session swap.  Draft K/V already cached
        was computed by the old draft — still fine: draft caches only
        bias PROPOSALS, and every proposal is verified by the target.
        Returns False when this replica no longer speculates (a failed
        draft restart downgraded it) so the watcher can report
        honestly instead of logging a swap that reached nobody."""
        if self.draft_session is None:
            return False
        self.draft_session.swap(version, params)
        return True

    def _on_step_error(self, exc: BaseException) -> bool:
        from theanompi_tpu_torch.serving.export import load_export

        self.restarts += 1
        monitor.inc("serving/replica_restarts_total", replica=self.idx)
        if self.restarts > self.max_restarts:
            print(f"[decode] replica {self.idx} exhausted "
                  f"{self.max_restarts} restarts "
                  f"({type(exc).__name__}: {exc}); marking it lost",
                  flush=True)
            return False
        try:
            # the version BEING SERVED, not the newest publish: a
            # restart must never become a side door past the reload
            # watcher's IncompatibleExport refusal (serving/server.py
            # Replica._on_batch_error has the same pin)
            loaded = load_export(self.export_dir,
                                 version=self.session.version)
        except Exception as e:
            print(f"[decode] replica {self.idx} restart-from-export "
                  f"failed ({type(e).__name__}: {e}); marking it lost",
                  flush=True)
            return False
        self.session.swap(loaded.version, loaded.state)
        # restart on zeroed pages (active sequences were already failed)
        self.session.reset_cache()
        if self.draft_session is not None:
            try:
                dloaded = load_export(self.draft_export_dir,
                                      version=self.draft_session.version)
                self.draft_session.swap(dloaded.version, dloaded.state)
                self.draft_session.reset_cache()
            except Exception as e:
                # the draft is an accelerator, not a dependency: a
                # failed draft reload costs speculation, never the
                # replica (runs on the scheduler thread, like every
                # cache mutation)
                print(f"[decode] replica {self.idx} draft restart "
                      f"failed ({type(e).__name__}: {e}); speculation "
                      "disabled, replica keeps serving", flush=True)
                self.batcher.disable_speculation()
                self.draft_session = None
        print(f"[decode] replica {self.idx} restarted from export "
              f"v{loaded.version} after {type(exc).__name__} "
              f"(restart {self.restarts}/{self.max_restarts})",
              flush=True)
        return True
