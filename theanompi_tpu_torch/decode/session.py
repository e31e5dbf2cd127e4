"""DecodeSession — prefill/decode programs over one in-place page pool.

Counterpart of ``theanompi_tpu/decode/session.py``.  One session owns a
replica's page pool (decode/kvcache.py) and runs the same program
families as the JAX package, each on the bucket discipline that keeps
steady state free of new shapes:

* **prefill** — one program per padded PROMPT-LENGTH bucket
  (``prefill_buckets``, powers of two): the whole prompt through the
  sliding-window full forward (decode/model.py), its last ``window``
  positions' K/V copied into the sequence's fresh pages; returns the
  last real token's logits.
* **decode** — one program per DECODE-BATCH bucket
  (``serving.batcher.default_buckets(max_seqs)``): the live sequences
  packed to the front, padded with inactive rows (whose writes go to
  the drop page), one token for every sequence in one step.
* **verify** (target role) — k drafted tokens plus the pending one as a
  (k+1)-token chunk in one bucketed step; the accept count is the
  longest prefix where the drafts equal the target's argmax, and the
  writes are count-masked, so rejected tokens are never written.
* **propose** / **commit** (draft role) — k greedy draft steps in one
  call, their K/V kept in scratch (plus one K/V-only pass for the k-th
  draft); ``commit`` writes the accepted prefix after the verdict.
* **extend** — a prefix-cache hit: the prompt SUFFIX attends the shared
  pages through the ring and writes only its own positions.
* **prefill_batch** — S prompt chunks (cold prompts from 0, prefix hits
  from their shared length) in one (decode bucket x prefill bucket)
  chunk step with per-row offsets, ring masks and count-masked writes.
* **cow_copy** and **adopt** — the copy-on-write page copy (fixed
  ``COPY_BUCKET`` pairs) and a migrated sequence's pages copied in.

Port-only differences.  PyTorch has neither ``jit`` nor buffer donation:

* the pool is preallocated once and every program writes it in place
  (indexed assignment), so the page tensors keep their storage
  (``data_ptr``) across every step and restart (``reset_cache`` zeroes
  them in place);
* JAX pins "steady state never recompiles" with trace counters; here
  each family records the bucket KEYS (the shapes) it has run in
  ``bucket_keys``, and ``compiles`` counts them per family: after the
  ``warmup*`` calls and a first pass of a workload, running the same
  workload again adds no key.

Sharing is host-side (refcounted ``PagePool`` + ``PrefixCache``) with
copy-on-write: ``_cow_prepare`` runs before every writing program and
replaces any shared page the write would touch with a private copy.

``swap`` (hot reload) publishes one ``(version, weights)`` tuple read
once per step, so a step in flight finishes on the weights it started
with.  Weights are a port ``state_dict``; f32 weights (an export loaded
with ``dequantize=True``, the default) are placed once in a net of
their own.  Quantized weights (``load_export(..., dequantize=False)``)
stay int8/bf16 on the device and are dequantized inside each step
(``dequantize_tree``), run through the net's modules with
``torch.func.functional_call``.

Host-side sequence state (page rows, lengths, the pool) is owned by the
replica's single scheduler thread (decode/scheduler.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.decode import kvcache
from theanompi_tpu_torch.decode.model import (
    chunk_block,
    decode_block,
    embed_tokens,
    final_logits,
    full_forward,
)
from theanompi_tpu_torch.serving.batcher import default_buckets, pick_bucket
from theanompi_tpu_torch.serving.export import (
    dequantize_tree,
    is_quantized_leaf,
)

#: pairs per COW copy program call (fixed shape); larger bursts loop
COPY_BUCKET = 8

FAMILIES = ("prefill", "decode", "verify", "propose", "commit", "extend",
            "prefill_batch", "cow_copy", "adopt")


def default_prefill_buckets(max_len: int,
                            cap: int = 512) -> tuple[int, ...]:
    """Powers of two from 8 up to min(cap, max_len)."""
    out = []
    b = 8
    while b <= min(int(cap), int(max_len)):
        out.append(b)
        b *= 2
    return tuple(out)


class _Seq:
    """One live sequence's host-side cache bookkeeping."""

    __slots__ = ("page_row", "length")

    def __init__(self, page_row: np.ndarray, length: int):
        self.page_row = page_row
        self.length = int(length)


class _Programs(nn.Module):
    """Runs a program over ``net`` — the wrapper ``functional_call``
    reparametrizes with per-step dequantized weights."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, fn, *args):
        return fn(self.net, *args)


def _quantized(state: dict) -> bool:
    return any(is_quantized_leaf(v) or (isinstance(v, torch.Tensor)
                                        and v.dtype == torch.bfloat16)
               for v in state.values())


class DecodeSession:
    """Paged-KV token generation for one exported transformer."""

    def __init__(self, model, params: dict | None = None, version: int = 0,
                 page_size: int = 16, pages_per_seq: int = 8,
                 max_seqs: int = 8,
                 prefill_buckets: tuple[int, ...] | None = None,
                 prefix_cache: bool = True):
        module = model.module
        if not getattr(model, "decode_capable", False) \
                or not hasattr(module, "blocks"):
            raise ValueError(
                f"{type(model).__name__} is not a decode-capable "
                "transformer; decode serves the TransformerLM family only")
        self.model = model
        self.device = torch.device(model.device)
        block = module.blocks[0]
        self.n_layers = len(module.blocks)
        self.n_heads = int(block.n_heads)
        self.d_model = int(block.d_model)
        self.max_len = int(module.max_len)
        self.dtype = module.dtype
        self.cfg = kvcache.CacheConfig(
            n_layers=self.n_layers, n_heads=self.n_heads,
            d_head=self.d_model // self.n_heads, page_size=page_size,
            pages_per_seq=pages_per_seq, max_seqs=max_seqs,
            dtype=str(self.dtype).replace("torch.", ""))
        self.window = self.cfg.window
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in (prefill_buckets or
                             default_prefill_buckets(self.max_len)))))
        if not self.prefill_buckets \
                or self.prefill_buckets[0] < 1 \
                or self.prefill_buckets[-1] > self.max_len:
            raise ValueError(
                f"prefill buckets {self.prefill_buckets} must be >= 1 "
                f"and <= max_len {self.max_len}")
        self.decode_buckets = default_buckets(int(max_seqs))
        self.max_prompt = self.prefill_buckets[-1]
        #: the net skeleton quantized weights run through (meta device:
        #: every parameter is supplied per step)
        self._programs: _Programs | None = None

        params = params if params is not None else module.state_dict()
        self._live = (int(version), self._place(params))
        self._swap_lock = make_lock("DecodeSession._swap_lock")

        self._ck, self._cv = kvcache.init_pages(self.cfg, self.device)
        self.pool = kvcache.PagePool(self.cfg)
        #: cross-request prefix cache (None = sharing disabled)
        self.prefix_cache = (kvcache.PrefixCache(self.pool, self.window)
                             if prefix_cache else None)
        #: page copies made to un-share a page before a write
        self.cow_copies = 0
        #: draft role: (scratch_k, scratch_v, bucket, n) pending commit
        self._scratch = None
        #: the bucket keys (shapes) each program family has run
        self.bucket_keys: dict[str, set] = {f: set() for f in FAMILIES}
        #: fleet prefix-cache client (decode/fleetcache.py), attached by
        #: the replica when a fleet cache authority is named: None =
        #: local-only sharing
        self.fleet = None

    # -- params ---------------------------------------------------------

    def _place(self, params: dict):
        """Weights on the device: a ready net for f32 weights, the
        device tree (int8/bf16 kept) for quantized ones."""
        if not _quantized(params):
            net = self.model.build_module()
            net.load_state_dict(params)
            return net.to(self.device).eval(), None
        if self._programs is None:
            self._programs = _Programs(
                self.model.build_module().to("meta").eval())
        tree = {k: ({kk: vv.to(self.device) for kk, vv in v.items()}
                    if is_quantized_leaf(v) else v.to(self.device))
                for k, v in params.items()}
        return None, tree

    @property
    def version(self) -> int:
        return self._live[0]

    @property
    def compiles(self) -> dict[str, int]:
        """Distinct bucket keys run per family (JAX's trace counters'
        counterpart)."""
        return {f: len(k) for f, k in self.bucket_keys.items()}

    @property
    def page_tensors(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._ck, self._cv

    def swap(self, version: int, params, model_state=None) -> bool:
        """Publish new weights (hot reload / restart-from-export);
        monotonic, and the cache is kept: in-flight sequences go on
        with the new weights.  ``model_state`` is accepted for the
        replica interface; the LM family has none."""
        del model_state
        with self._swap_lock:
            if int(version) < self._live[0]:
                return False
            self._live = (int(version), self._place(params))
            return True

    def _run(self, live, family: str, key, fn, *args):
        """One program call on the ``live`` weights snapshot, recording
        ``key`` under ``family``."""
        self.bucket_keys[family].add(key)
        net, tree = live
        with torch.no_grad():
            if net is not None:
                return fn(net, *args)
            p = dequantize_tree(tree)
            return torch.func.functional_call(
                self._programs, {f"net.{k}": v for k, v in p.items()},
                (fn, *args))

    def _t(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    # -- programs (each writes the pool in place) -----------------------

    def _layers(self, net, x, page_rows, mask, chunk: bool):
        k_new, v_new = [], []
        for layer, block in enumerate(net.blocks):
            kc = kvcache.gather_layer(self._ck[layer], page_rows)
            vc = kvcache.gather_layer(self._cv[layer], page_rows)
            if chunk:
                x, kn, vn = chunk_block(block, x, kc, vc, mask,
                                        window=self.window)
            else:
                x, kn, vn = decode_block(block, x, kc, vc, mask)
            k_new.append(kn)
            v_new.append(vn)
        return x, torch.stack(k_new), torch.stack(v_new)

    def _prefill_fn(self, net, tokens, length: int, page_row):
        logits, ks, vs = full_forward(net, tokens, window=self.window)
        shape = (self.n_layers, self.cfg.pages_per_seq, self.cfg.page_size,
                 self.n_heads, self.cfg.d_head)
        for pages, kv in ((self._ck, ks), (self._cv, vs)):
            ring = torch.stack([kvcache.ring_from_prompt(
                t[0], length, self.window) for t in kv]).reshape(shape)
            pages[:, page_row] = ring
        return logits[0, length - 1]

    def _decode_fn(self, net, tokens, lengths, page_rows, active):
        pos = torch.clamp(lengths, max=self.max_len - 1)
        x = embed_tokens(net, tokens, pos)[:, None, :].to(self.dtype)
        mask = kvcache.cache_mask(lengths, self.window)
        x, k_new, v_new = self._layers(net, x, page_rows, mask, False)
        # every write is THIS token's: after every layer's gather
        kvcache.write_token_all(self._ck, page_rows, lengths, active, k_new)
        kvcache.write_token_all(self._cv, page_rows, lengths, active, v_new)
        return final_logits(net, x)[:, 0]

    def _chunk_fn(self, net, tokens, starts, page_rows):
        c = tokens.shape[1]
        pos = torch.clamp(starts[:, None] + torch.arange(
            c, device=self.device), max=self.max_len - 1)
        x = embed_tokens(net, tokens, pos).to(self.dtype)
        mask = kvcache.chunk_cache_mask(starts, c, self.window)
        return self._layers(net, x, page_rows, mask, True)

    def _verify_fn(self, net, tokens, lengths, page_rows, active):
        x, k_new, v_new = self._chunk_fn(net, tokens, lengths, page_rows)
        y = torch.argmax(final_logits(net, x), dim=-1)       # (S, k+1)
        # d_i accepted iff it equals y_{i-1} and every earlier draft did
        match = (tokens[:, 1:] == y[:, :-1]).long()
        m = torch.cumprod(match, dim=1).sum(dim=1)
        counts = torch.where(active, m + 1, torch.zeros_like(m))
        kvcache.write_tokens_all(self._ck, page_rows, lengths, counts, k_new)
        kvcache.write_tokens_all(self._cv, page_rows, lengths, counts, v_new)
        return y, counts

    def _propose_fn(self, net, tokens, lengths, page_rows, k: int):
        """k greedy one-token steps; token i attends the ring, scratch
        tokens 0..i-1 and itself; one more K/V-only pass for the k-th
        draft.  Nothing is written."""
        s_ = tokens.shape[0]
        ring_mask = kvcache.chunk_cache_mask(lengths, k + 1, self.window)
        rk = [kvcache.gather_layer(self._ck[i], page_rows)
              for i in range(self.n_layers)]
        rv = [kvcache.gather_layer(self._cv[i], page_rows)
              for i in range(self.n_layers)]
        sk = [[] for _ in range(self.n_layers)]
        sv = [[] for _ in range(self.n_layers)]
        drafts = []
        tok = tokens
        for i in range(k + 1):
            pos = torch.clamp(lengths + i, max=self.max_len - 1)
            x = embed_tokens(net, tok, pos)[:, None, :].to(self.dtype)
            for layer, block in enumerate(net.blocks):
                if i:
                    kc = torch.cat([rk[layer], torch.stack(sk[layer], 1)], 1)
                    vc = torch.cat([rv[layer], torch.stack(sv[layer], 1)], 1)
                    m = torch.cat([ring_mask[:, i], torch.ones(
                        (s_, i), dtype=torch.bool, device=self.device)], 1)
                else:
                    kc, vc, m = rk[layer], rv[layer], ring_mask[:, 0]
                x, kn, vn = decode_block(block, x, kc, vc, m)
                sk[layer].append(kn)
                sv[layer].append(vn)
            if i < k:
                tok = torch.argmax(final_logits(net, x)[:, 0], dim=-1)
                drafts.append(tok)
        return (torch.stack(drafts, 1),
                torch.stack([torch.stack(s, 1) for s in sk]),
                torch.stack([torch.stack(s, 1) for s in sv]))

    def _commit_fn(self, net, sk, sv, lengths, page_rows, counts):
        del net
        kvcache.write_tokens_all(self._ck, page_rows, lengths, counts, sk)
        kvcache.write_tokens_all(self._cv, page_rows, lengths, counts, sv)

    def _extend_fn(self, net, tokens, starts, counts, page_rows):
        """Prefix-hit prefill and batched prefill: each row's chunk from
        its start offset; writes count-masked per row (padding rows and
        window-evicted positions reach only the drop page)."""
        x, k_new, v_new = self._chunk_fn(net, tokens, starts, page_rows)
        logits = final_logits(net, x)                        # (S, C, V)
        kvcache.write_tokens_all(self._ck, page_rows, starts, counts, k_new)
        kvcache.write_tokens_all(self._cv, page_rows, starts, counts, v_new)
        last = torch.clamp(counts - 1, 0, tokens.shape[1] - 1)
        return logits[torch.arange(logits.shape[0], device=self.device),
                      last]

    def _copy_fn(self, net, src, dst):
        del net
        for pages in (self._ck, self._cv):
            pages[:, dst] = pages[:, src]

    def _adopt_fn(self, net, k_new, v_new, page_row):
        del net
        self._ck[:, page_row] = k_new.to(self.device, self.dtype)
        self._cv[:, page_row] = v_new.to(self.device, self.dtype)

    # -- scheduler-facing host API (single scheduler thread) ------------

    def _drop_rows(self, n: int) -> np.ndarray:
        return np.full((n, self.cfg.pages_per_seq), self.cfg.n_pages,
                       np.int64)

    def can_admit(self, n: int = 1) -> bool:
        """Whether ``n`` more sequences could allocate full page rows
        (cache-only pages count: LRU eviction frees them)."""
        free = self.pool.free_pages
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_pages()
        return free >= int(n) * self.cfg.pages_per_seq

    def _alloc_pages(self, n: int) -> list[int] | None:
        """Allocate, evicting prefix-cache LRU entries under pressure."""
        while True:
            got = self.pool.alloc(n)
            if got is not None:
                return got
            if self.prefix_cache is None or not len(self.prefix_cache):
                return None
            self.prefix_cache.evict_lru()

    def _cow_prepare(self, seqs: list[_Seq], span: int) -> None:
        """Copy-on-write fence before a program that writes positions
        ``[length, length+span)``: every touched page still shared is
        swapped for a private copy first."""
        ps = self.cfg.page_size
        src, dst = [], []
        for s in seqs:
            touched = sorted({(p % self.window) // ps
                              for p in range(s.length, s.length + span)})
            for idx in touched:
                pid = int(s.page_row[idx])
                while self.pool.refcount(pid) > 1:
                    got = self.pool.alloc(1)
                    if got is None:
                        if (self.prefix_cache is not None
                                and len(self.prefix_cache)):
                            self.prefix_cache.evict_lru()
                            continue
                        raise RuntimeError(
                            "page pool exhausted during copy-on-write")
                    src.append(pid)
                    dst.append(got[0])
                    self.pool.decref([pid])
                    s.page_row[idx] = got[0]
                    self.cow_copies += 1
                    break
        _, live = self._live
        for i in range(0, len(src), COPY_BUCKET):
            sb = np.zeros(COPY_BUCKET, np.int64)
            db = np.full(COPY_BUCKET, self.cfg.n_pages, np.int64)
            chunk = src[i:i + COPY_BUCKET]
            sb[:len(chunk)] = chunk
            db[:len(chunk)] = dst[i:i + COPY_BUCKET]
            self._run(live, "cow_copy", COPY_BUCKET, self._copy_fn,
                      self._t(sb), self._t(db))

    def _prefill(self, live, prompt: np.ndarray, page_row) -> np.ndarray:
        t = prompt.shape[0]
        bucket = pick_bucket(t, self.prefill_buckets)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :t] = prompt
        out = self._run(live, "prefill", bucket, self._prefill_fn,
                        self._t(tokens), t, self._t(page_row))
        return out.float().cpu().numpy()

    def _extend(self, live, toks, starts, counts, rows) -> np.ndarray:
        key = ("extend" if toks.shape[0] == 1 else "prefill_batch")
        out = self._run(live, key, toks.shape, self._extend_fn,
                        self._t(toks), self._t(starts), self._t(counts),
                        self._t(rows))
        return out.float().cpu().numpy()

    def admit(self, prompt: np.ndarray) -> tuple[_Seq, np.ndarray]:
        """Allocate pages, prefill the prompt, return the new sequence
        and the last real token's f32 logits (V,).  A prompt starting
        with a cached page-aligned prefix aliases the shared pages and
        prefills only the suffix (``extend``); either way the prompt's
        own prefixes are registered for the next stream."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        t = prompt.shape[0]
        if not 1 <= t <= self.max_prompt:
            raise ValueError(
                f"prompt length {t} outside [1, {self.max_prompt}] "
                "(largest prefill bucket)")
        _, live = self._live            # one-read snapshot
        hit = self._lookup_prefix(prompt)
        if hit is not None:
            # adopt the shared pages BEFORE any allocation that could
            # evict the entry
            self.pool.incref(hit.pages)
            fresh = self._alloc_pages(
                self.cfg.pages_per_seq - len(hit.pages))
            if fresh is None:
                self.pool.decref(hit.pages)
                raise RuntimeError(
                    "admit() without free pages — the scheduler must "
                    "check can_admit() first")
            page_row = np.asarray(list(hit.pages) + fresh, np.int32)
            start, suffix = hit.n_tokens, t - hit.n_tokens
            bucket = pick_bucket(suffix, self.prefill_buckets)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :suffix] = prompt[start:]
            try:
                logits = self._extend(live, tokens, [start], [suffix],
                                      page_row[None])[0]
            except Exception:
                self.pool.decref(page_row)
                raise
        else:
            got = self._alloc_pages(self.cfg.pages_per_seq)
            if got is None:
                raise RuntimeError(
                    "admit() without free pages — the scheduler must "
                    "check can_admit() first")
            page_row = np.asarray(got, np.int32)
            try:
                logits = self._prefill(live, prompt, page_row)
            except Exception:
                self.pool.free_seq(page_row)
                raise
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, page_row)
        if hit is None:
            self._fleet_register(prompt, page_row)
        return _Seq(page_row, t), logits

    def _lookup_prefix(self, prompt: np.ndarray):
        """Local prefix-cache lookup, then the fleet cache when one is
        attached (a fleet hit adopts the shipped pages and re-resolves
        locally)."""
        if self.prefix_cache is None:
            return None
        hit = self.prefix_cache.lookup(prompt)
        if hit is None and self.fleet is not None \
                and self.fleet.fetch(self, prompt):
            hit = self.prefix_cache.lookup(prompt)
        return hit

    def _fleet_register(self, prompt: np.ndarray, page_row) -> None:
        """Offer a cold prompt's longest page-aligned proper prefix to an
        attached fleet cache (best effort)."""
        if self.fleet is None or self.prefix_cache is None:
            return
        t = int(prompt.shape[0])
        if t > self.window:
            return
        q = (t - 1) // self.cfg.page_size
        if q < 1:
            return
        self.fleet.register(self, prompt[:q * self.cfg.page_size],
                            [int(p) for p in page_row[:q]])

    def admit_batch(self, prompts) -> list[tuple[_Seq, np.ndarray]]:
        """Admit up to ``max_seqs`` prompts in ONE batched prefill/extend
        call; one ``(seq, last-token logits)`` per prompt, in order.  Any
        row's allocation failure, or a failed program, drops every
        reference taken, so a failed batch leaks nothing.  A singleton
        rides the serial families."""
        n = len(prompts)
        if not 1 <= n <= self.cfg.max_seqs:
            raise ValueError(
                f"{n} prompts outside [1, {self.cfg.max_seqs}]")
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        for p in prompts:
            if not 1 <= p.shape[0] <= self.max_prompt:
                raise ValueError(
                    f"prompt length {p.shape[0]} outside "
                    f"[1, {self.max_prompt}] (largest prefill bucket)")
        if n == 1:
            return [self.admit(prompts[0])]
        _, live = self._live            # one-read snapshot
        rows: list[tuple] = []  # (prompt, page_row, start, suffix, cold)
        try:
            for prompt in prompts:
                t = prompt.shape[0]
                hit = self._lookup_prefix(prompt)
                if hit is not None:
                    self.pool.incref(hit.pages)
                    fresh = self._alloc_pages(
                        self.cfg.pages_per_seq - len(hit.pages))
                    if fresh is None:
                        self.pool.decref(hit.pages)
                        raise RuntimeError(
                            "admit_batch() without free pages — the "
                            "scheduler must check can_admit(n) first")
                    page_row = np.asarray(list(hit.pages) + fresh,
                                          np.int32)
                    rows.append((prompt, page_row, hit.n_tokens,
                                 t - hit.n_tokens, False))
                else:
                    got = self._alloc_pages(self.cfg.pages_per_seq)
                    if got is None:
                        raise RuntimeError(
                            "admit_batch() without free pages — the "
                            "scheduler must check can_admit(n) first")
                    rows.append((prompt, np.asarray(got, np.int32),
                                 0, t, True))
        except Exception:
            for _, page_row, *_ in rows:
                self.pool.decref(page_row)
            raise
        sbucket = pick_bucket(n, self.decode_buckets)
        cbucket = pick_bucket(max(r[3] for r in rows), self.prefill_buckets)
        toks = np.zeros((sbucket, cbucket), np.int64)
        starts = np.zeros((sbucket,), np.int64)
        counts = np.zeros((sbucket,), np.int64)
        prow = self._drop_rows(sbucket)
        for i, (prompt, page_row, start, suffix, _) in enumerate(rows):
            toks[i, :suffix] = prompt[start:]
            starts[i] = start
            counts[i] = suffix
            prow[i] = page_row
        try:
            logits = self._extend(live, toks, starts, counts, prow)
        except Exception:
            for _, page_row, *_ in rows:
                self.pool.decref(page_row)
            raise
        out = []
        for i, (prompt, page_row, _, _, cold) in enumerate(rows):
            if self.prefix_cache is not None:
                self.prefix_cache.insert(prompt, page_row)
            if cold:
                self._fleet_register(prompt, page_row)
            out.append((_Seq(page_row, prompt.shape[0]), logits[i]))
        return out

    def _pack(self, seqs: list[_Seq], first) -> tuple:
        """Bucket-padded (tokens, lengths, page rows, active) of
        ``seqs``; ``first[i]`` is row i's token(s)."""
        n = len(seqs)
        if not 1 <= n <= self.cfg.max_seqs:
            raise ValueError(f"{n} sequences outside "
                             f"[1, {self.cfg.max_seqs}]")
        bucket = pick_bucket(n, self.decode_buckets)
        first = np.asarray(first, np.int64)
        toks = np.zeros((bucket, *first.shape[1:]), np.int64)
        toks[:n] = first
        lens = np.zeros((bucket,), np.int64)
        rows = self._drop_rows(bucket)
        active = np.zeros((bucket,), bool)
        for i, s in enumerate(seqs):
            lens[i] = s.length
            rows[i] = s.page_row
            active[i] = True
        return (bucket, self._t(toks), self._t(lens), self._t(rows),
                self._t(active, torch.bool))

    def decode(self, seqs: list[_Seq], tokens: np.ndarray) -> np.ndarray:
        """One decode step for every sequence in ``seqs`` (their freshly
        sampled ``tokens``, one each); returns f32 logits (len(seqs), V)
        for the NEXT token; each length advances by one."""
        n = len(seqs)
        if not 1 <= n <= self.cfg.max_seqs:
            raise ValueError(f"{n} sequences outside "
                             f"[1, {self.cfg.max_seqs}]")
        self._cow_prepare(seqs, 1)
        bucket, toks, lens, rows, active = self._pack(
            seqs, np.asarray(tokens).reshape(-1)[:n])
        _, live = self._live            # one-read snapshot
        logits = self._run(live, "decode", bucket, self._decode_fn, toks,
                           lens, rows, active)
        for s in seqs:
            s.length += 1
        return logits.float().cpu().numpy()[:n]

    def verify(self, seqs: list[_Seq], pending: np.ndarray,
               drafts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Target role: check each sequence's k drafts in ONE bucketed
        step.  Returns (y (n, k+1), the target's greedy token at every
        chunk position, and counts (n,) = accepted drafts + 1); each
        length advances by its count."""
        n = len(seqs)
        drafts = np.asarray(drafts, np.int64).reshape(n, -1)
        k1 = drafts.shape[1] + 1
        if not 1 <= n <= self.cfg.max_seqs:
            raise ValueError(f"{n} sequences outside "
                             f"[1, {self.cfg.max_seqs}]")
        if k1 > self.window:
            raise ValueError(f"speculation chunk {k1} exceeds the "
                             f"ring window {self.window}")
        self._cow_prepare(seqs, k1)
        chunk = np.concatenate(
            [np.asarray(pending, np.int64).reshape(n, 1), drafts], 1)
        bucket, toks, lens, rows, active = self._pack(seqs, chunk)
        _, live = self._live            # one-read snapshot
        y, counts = self._run(live, "verify", (bucket, k1),
                              self._verify_fn, toks, lens, rows, active)
        y = y.cpu().numpy()[:n]
        counts = counts.cpu().numpy()[:n]
        for i, s in enumerate(seqs):
            s.length += int(counts[i])
        return y, counts

    def propose(self, seqs: list[_Seq], pending: np.ndarray,
                k: int) -> np.ndarray:
        """Draft role: k greedy proposals per sequence in one call; their
        K/V stays in scratch until :meth:`commit`.  Returns (n, k)."""
        n = len(seqs)
        if not 1 <= int(k) <= self.window - 1:
            raise ValueError(f"speculate_k {k} outside "
                             f"[1, window-1={self.window - 1}]")
        bucket, toks, lens, rows, _ = self._pack(
            seqs, np.asarray(pending).reshape(-1)[:n])
        _, live = self._live            # one-read snapshot
        drafts, sk, sv = self._run(live, "propose", (bucket, int(k)),
                                   self._propose_fn, toks, lens, rows,
                                   int(k))
        self._scratch = (sk, sv, bucket, n)
        return drafts.cpu().numpy()[:n]

    def commit(self, seqs: list[_Seq], counts: np.ndarray) -> None:
        """Draft role: write the accepted prefix of the last
        :meth:`propose` scratch and advance lengths."""
        if self._scratch is None:
            raise RuntimeError("commit() without a pending propose()")
        sk, sv, bucket, n = self._scratch
        self._scratch = None
        if len(seqs) != n:
            raise ValueError(f"commit over {len(seqs)} sequences but "
                             f"propose ran over {n}")
        self._cow_prepare(seqs, int(sk.shape[2]))
        cnt = np.zeros((bucket,), np.int64)
        cnt[:n] = np.asarray(counts).reshape(-1)[:n]
        _, lens, rows, _ = self._pack(seqs, np.zeros(n))[1:]
        _, live = self._live
        self._run(live, "commit", (bucket, int(sk.shape[2])),
                  self._commit_fn, sk, sv, lens, rows, self._t(cnt))
        for i, s in enumerate(seqs):
            s.length += int(cnt[i])

    def release(self, seq: _Seq) -> None:
        self.pool.free_seq(seq.page_row)

    # -- page migration (decode/migrate.py) -----------------------------

    def export_pages(self, seq: _Seq) -> tuple[torch.Tensor, torch.Tensor]:
        """One sequence's KV pages as CPU tensors, ring layout verbatim:
        ``(n_layers, pages_per_seq, page_size, n_heads, d_head)`` per
        pool.  Call before release."""
        return self.export_page_ids(seq.page_row)

    def export_page_ids(self, pages) -> tuple[torch.Tensor, torch.Tensor]:
        """Arbitrary page ids' KV as CPU tensors ``(n_layers, len(pages),
        page_size, n_heads, d_head)`` per pool."""
        rows = self._t(np.asarray(pages).reshape(-1))
        return self._ck[:, rows].cpu(), self._cv[:, rows].cpu()

    def export_pages_batch(self, seqs: list[_Seq]) -> list[tuple]:
        """Every sequence's pages in one gather over the stacked page rows
        and one copy to the host (the batched prefill server's export);
        the same bytes as a per-sequence :meth:`export_pages` each."""
        rows = self._t(np.stack([s.page_row for s in seqs]))
        k, v = self._ck[:, rows].cpu(), self._cv[:, rows].cpu()
        return [(k[:, i], v[:, i]) for i in range(len(seqs))]

    def _adopt(self, k, v, page_row) -> None:
        _, live = self._live
        k, v = (a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.array(a)) for a in (k, v))
        self._run(live, "adopt", self.cfg.pages_per_seq, self._adopt_fn,
                  k, v, self._t(page_row))

    def adopt_prefix(self, prefix: np.ndarray, k, v) -> bool:
        """Adopt shipped PREFIX pages (``q`` filled pages of a
        page-aligned prompt prefix, ``(n_layers, q, page_size, n_heads,
        d_head)`` per pool) as cache content, zero-padded to the adopt
        program's full row.  False, with nothing adopted, when sharing
        is off, the prefix is already registered or the pool stays too
        tight."""
        if self.prefix_cache is None:
            return False
        prefix = np.asarray(prefix, np.int32).reshape(-1)
        t = prefix.shape[0]
        ps, pps = self.cfg.page_size, self.cfg.pages_per_seq
        q = t // ps
        if t < ps or t % ps or t > self.window:
            raise ValueError(
                f"adopt_prefix needs a page-aligned prefix of 1..{pps}"
                f" pages, got {t} tokens")
        expect = (self.n_layers, q, ps, self.n_heads, self.cfg.d_head)
        if tuple(k.shape) != expect or tuple(v.shape) != expect:
            raise ValueError(
                f"prefix page arrays {tuple(k.shape)}/{tuple(v.shape)}"
                f" do not match {expect}")
        if self.prefix_cache.contains(prefix):
            return False
        got = self._alloc_pages(q)
        if got is None:
            return False
        shape = (self.n_layers, pps, ps, self.n_heads, self.cfg.d_head)
        kf = torch.zeros(shape, dtype=self.dtype)
        vf = torch.zeros(shape, dtype=self.dtype)
        kf[:, :q] = torch.as_tensor(k)
        vf[:, :q] = torch.as_tensor(v)
        page_row = np.full((pps,), self.cfg.n_pages, np.int64)
        page_row[:q] = got
        try:
            self._adopt(kf, vf, page_row)
        except Exception:
            self.pool.decref(got)
            raise
        self.prefix_cache.insert_pages(prefix, got)
        # the entries hold their own refs: the pages become cache-owned
        self.pool.decref(got)
        return True

    def adopt_pages(self, manifest: dict, k, v) -> _Seq:
        """Adopt a migrated sequence: validate the manifest and arrays
        against this pool (typed ``IncompatiblePages``), allocate a page
        row, copy the pages in, and register the prompt's prefixes as a
        local admit would."""
        from theanompi_tpu_torch.decode import migrate

        reason = migrate.pages_incompatibility(manifest, k, v, self.cfg)
        if reason is not None:
            raise migrate.IncompatiblePages(reason)
        got = self._alloc_pages(self.cfg.pages_per_seq)
        if got is None:
            raise RuntimeError(
                "adopt_pages() without free pages — the scheduler "
                "must check can_admit() first")
        page_row = np.asarray(got, np.int32)
        try:
            self._adopt(k, v, page_row)
        except Exception:
            self.pool.free_seq(page_row)
            raise
        prompt = np.asarray(manifest["prompt"], np.int32)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, page_row)
        return _Seq(page_row, int(manifest["length"]))

    def reset_cache(self) -> None:
        """Zeroed pages (in place) and a fresh allocator: the
        restart-from-export path (the scheduler failed and released the
        live sequences first)."""
        self._ck.zero_()
        self._cv.zero_()
        self.pool = kvcache.PagePool(self.cfg)
        if self.prefix_cache is not None:
            self.prefix_cache = kvcache.PrefixCache(self.pool, self.window)
        self._scratch = None

    # -- warmup ---------------------------------------------------------

    def warmup(self) -> None:
        """Run the smallest prefill and decode programs (and, with the
        prefix cache, the smallest extend and the COW copy) and the
        adopt copy before the port binds; every write goes to the drop
        page."""
        _, live = self._live
        drop = self._drop_rows(1)
        prompt = np.zeros((1,), np.int32)
        self._prefill(live, prompt, drop[0])
        bucket = self.decode_buckets[0]
        z = self._t(np.zeros(bucket))
        self._run(live, "decode", bucket, self._decode_fn, z, z,
                  self._t(self._drop_rows(bucket)),
                  self._t(np.zeros(bucket, bool), torch.bool))
        if self.prefix_cache is not None:
            tokens = np.zeros((1, self.prefill_buckets[0]), np.int64)
            self._extend(live, tokens, [0], [1], drop)
            self._run(live, "cow_copy", COPY_BUCKET, self._copy_fn,
                      self._t(np.zeros(COPY_BUCKET)),
                      self._t(np.full(COPY_BUCKET, self.cfg.n_pages)))
        shape = (self.n_layers, self.cfg.pages_per_seq, self.cfg.page_size,
                 self.n_heads, self.cfg.d_head)
        zero = torch.zeros(shape, dtype=self.dtype)
        self._adopt(zero, zero, drop[0])

    def warmup_prefill_batch(self) -> None:
        """Run the batched prefill for EVERY (decode bucket >= 2 x
        prefill bucket) pair: batch occupancy varies run to run."""
        _, live = self._live
        for sb in self.decode_buckets:
            if sb < 2:
                continue
            z = np.zeros((sb,), np.int64)
            for cb in self.prefill_buckets:
                self._extend(live, np.zeros((sb, cb), np.int64), z, z,
                             self._drop_rows(sb))

    def warmup_spec(self, k: int, role: str) -> None:
        """Run the speculative programs at the smallest decode bucket:
        ``'target'`` verify, ``'draft'`` propose + commit."""
        _, live = self._live
        bucket = self.decode_buckets[0]
        rows = self._t(self._drop_rows(bucket))
        z = self._t(np.zeros(bucket))
        if role == "target":
            self._run(live, "verify", (bucket, int(k) + 1),
                      self._verify_fn,
                      self._t(np.zeros((bucket, int(k) + 1))), z, rows,
                      self._t(np.zeros(bucket, bool), torch.bool))
        elif role == "draft":
            _, sk, sv = self._run(live, "propose", (bucket, int(k)),
                                  self._propose_fn, z, z, rows, int(k))
            self._run(live, "commit", (bucket, int(k) + 1),
                      self._commit_fn, sk, sv, z, rows, z)
        else:
            raise ValueError(f"unknown warmup role {role!r}")
