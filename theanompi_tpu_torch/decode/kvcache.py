"""Paged/ring KV cache: device page tensors written in place, and a
host-side refcounted pool.

Counterpart of ``theanompi_tpu/decode/kvcache.py``.  The device state is
ONE pool per replica, ``k_pages``/``v_pages`` of shape ``(layers,
n_pages + 1, page_size, heads, d_head)``, allocated once and never
resized: every write is an in-place indexed assignment, so
the tensors keep their storage for the replica's life.  The pool holds
one page more than :attr:`CacheConfig.n_pages`: the DROP page, id
``n_pages``.  JAX scatters with ``mode="drop"`` and gathers out-of-range
ids clamped; here a write routed to id ``n_pages`` (an inactive bucket
row, a rejected draft token, a position the ring has already evicted)
lands on the drop page, and a gather of a padding row reads it.  No
live page table ever holds that id, so what it holds is never attended.

Sequences own pages through a **page table** (``pages_per_seq`` ids per
live sequence) and are a **ring** over ``window = pages_per_seq *
page_size`` slots: the token at absolute position ``p`` lives in slot
``p % window``, so eviction past the window is the ring wrapping, and
attention covers exactly the last ``window`` tokens (the full-forward
oracle is the same model under a sliding-window mask,
decode/model.py ``full_forward``).

Pages are REFCOUNTED (:class:`PagePool`): a page table may alias pages
owned by other sequences or by the cross-request :class:`PrefixCache`;
the session un-shares a page before it writes to it (copy-on-write,
``DecodeSession._cow_prepare``).  The pool and the cache are owned by
one scheduler thread (decode/scheduler.py): no locks by design.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Shape contract of one replica's page pool."""

    n_layers: int
    n_heads: int
    d_head: int
    #: tokens per page (the allocation granule)
    page_size: int = 16
    #: pages per live sequence — fixes the ring window
    pages_per_seq: int = 8
    #: max concurrently-live sequences (the decode batch ceiling)
    max_seqs: int = 8
    #: KV storage dtype (the model's compute dtype)
    dtype: str = "float32"

    def __post_init__(self):
        for f in ("n_layers", "n_heads", "d_head", "page_size",
                  "pages_per_seq", "max_seqs"):
            if int(getattr(self, f)) < 1:
                raise ValueError(f"CacheConfig.{f} must be >= 1")

    @property
    def window(self) -> int:
        """Ring capacity in tokens = the attention context window."""
        return self.page_size * self.pages_per_seq

    @property
    def n_pages(self) -> int:
        """Pages a table may name: every slot's worth of sequences can
        hold a full ring (admission fails on max_seqs, never on
        pages).  The id ``n_pages`` is the drop page."""
        return self.max_seqs * self.pages_per_seq


def init_pages(cfg: CacheConfig, device="cpu"):
    """The replica's page pool, zeros: ``(k_pages, v_pages)`` of shape
    ``(n_layers, n_pages + 1, page_size, n_heads, d_head)`` (the last
    page is the drop page)."""
    shape = (cfg.n_layers, cfg.n_pages + 1, cfg.page_size, cfg.n_heads,
             cfg.d_head)
    dt = getattr(torch, cfg.dtype)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


# ---------------------------------------------------------------------------
# Ring math
# ---------------------------------------------------------------------------


def stored_positions(lengths: torch.Tensor, window: int) -> torch.Tensor:
    """Absolute token position held by each ring slot: slot ``j`` of a
    sequence of ``length`` tokens holds ``(length-1) - ((length-1-j) mod
    window)``, negative where no position has reached it yet.
    ``lengths``: (S,); returns (S, window) int64."""
    j = torch.arange(window, device=lengths.device)[None, :]
    last = lengths.long()[:, None] - 1
    return last - torch.remainder(last - j, window)


def cache_mask(lengths: torch.Tensor, window: int) -> torch.Tensor:
    """(S, window) bool: the slots the NEXT token (position ``length``)
    may attend — written and inside the sliding window (the slot it is
    about to overwrite holds ``length - window`` and is excluded)."""
    pos = stored_positions(lengths, window)
    lens = lengths.long()[:, None]
    return (pos >= 0) & (pos > lens - window)


def chunk_cache_mask(lengths: torch.Tensor, chunk: int,
                     window: int) -> torch.Tensor:
    """(S, chunk, window) bool: the slots the chunk's ``i``-th new token
    (position ``length + i``) may attend in the PRE-write ring — the
    per-query :func:`cache_mask` of the verify/extend programs."""
    pos = stored_positions(lengths, window)
    qpos = (lengths.long()[:, None]
            + torch.arange(chunk, device=lengths.device)[None, :])
    return ((pos[:, None, :] >= 0)
            & (pos[:, None, :] > qpos[:, :, None] - window))


def ring_from_prompt(kv: torch.Tensor, length: int,
                     window: int) -> torch.Tensor:
    """One prompt's per-position K or V ``(T_pad, heads, d_head)`` in its
    ring layout ``(window, heads, d_head)``: the last ``min(length,
    window)`` real positions, each at slot ``p % window``; pad rows and
    evicted positions are dropped."""
    length = int(length)
    lo = max(0, length - window)
    pos = torch.arange(lo, length, device=kv.device)
    ring = kv.new_zeros((window, *kv.shape[1:]))
    ring[torch.remainder(pos, window)] = kv[lo:length]
    return ring


# ---------------------------------------------------------------------------
# Page gather / in-place writes
# ---------------------------------------------------------------------------


def gather_layer(pages: torch.Tensor, page_rows: torch.Tensor
                 ) -> torch.Tensor:
    """One layer's cached KV per sequence, ring-ordered.  ``pages``:
    (n_pages + 1, page_size, H, D); ``page_rows``: (S, pages_per_seq).
    Returns (S, window, H, D): slot ``j`` is page ``j // page_size``
    offset ``j % page_size``."""
    s, pps = page_rows.shape
    g = pages[page_rows]
    return g.reshape(s, pps * pages.shape[1], *pages.shape[2:])


def write_tokens_all(pages: torch.Tensor, page_rows: torch.Tensor,
                     lengths: torch.Tensor, counts: torch.Tensor,
                     kv: torch.Tensor) -> None:
    """Write the first ``counts[s]`` of C new tokens per sequence
    (positions ``length .. length+counts-1``) into the pool IN PLACE,
    all layers in one indexed assignment.  ``pages``: (L, n_pages + 1,
    page_size, H, D); ``kv``: (L, S, C, H, D).  A token past its row's
    count, or more than ``window`` positions behind it (already
    evicted), goes to the drop page, so rejected drafts and padding rows
    never reach a live page and a count may exceed the window."""
    page_size = pages.shape[2]
    drop = pages.shape[1] - 1
    window = page_rows.shape[1] * page_size
    c = kv.shape[2]
    i = torch.arange(c, device=pages.device)[None, :]
    slot = torch.remainder(lengths.long()[:, None] + i, window)
    page = torch.gather(page_rows.long(), 1, slot // page_size)
    cnt = counts.long()[:, None]
    page = torch.where((i < cnt) & (i >= cnt - window), page,
                       torch.full_like(page, drop))
    off = torch.remainder(slot, page_size)
    pages[:, page, off] = kv.to(pages.dtype)


def write_token_all(pages: torch.Tensor, page_rows: torch.Tensor,
                    lengths: torch.Tensor, active: torch.Tensor,
                    kv: torch.Tensor) -> None:
    """Each sequence's NEW token (position ``length``) into the pool:
    :func:`write_tokens_all` with a chunk of 1; inactive rows write
    nothing.  ``kv``: (L, S, H, D)."""
    write_tokens_all(pages, page_rows, lengths, active.long(),
                     kv[:, :, None])


# ---------------------------------------------------------------------------
# Host-side allocator (a copy of the JAX package's)
# ---------------------------------------------------------------------------


class PagePool:
    """Refcounted free-list page allocator for one replica's pool.

    A page's refcount counts every page-table slot and every
    :class:`PrefixCache` entry holding it; it returns to the free list
    when the LAST reference drops.  A refcount > 1 marks the page
    read-only for writers (the session's copy-on-write check).  Owned by
    one scheduler thread: not thread-safe by design."""

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        self._free = list(range(cfg.n_pages - 1, -1, -1))
        self._refs = np.zeros(cfg.n_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_fraction(self) -> float:
        return 1.0 - len(self._free) / self.cfg.n_pages

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh pages at refcount 1, or None when the free list
        cannot cover it."""
        if len(self._free) < n:
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._refs[ids] = 1
        return ids

    def alloc_seq(self) -> np.ndarray | None:
        """One sequence's page row (``pages_per_seq`` ids), or None."""
        ids = self.alloc(self.cfg.pages_per_seq)
        return None if ids is None else np.asarray(ids, np.int32)

    def incref(self, pages) -> None:
        """Adopt already-allocated pages (a prefix hit aliasing shared
        pages, or a cache entry registering a prefill's pages)."""
        for p in np.asarray(pages, np.int64).reshape(-1).tolist():
            if not 0 <= p < self.cfg.n_pages:
                raise ValueError(f"incref of foreign page id {p}")
            if self._refs[p] < 1:
                raise ValueError(f"incref of free page {p}")
            self._refs[p] += 1

    def decref(self, pages) -> int:
        """Drop one reference per page; returns how many pages were
        freed."""
        freed = 0
        for p in np.asarray(pages, np.int64).reshape(-1).tolist():
            if not 0 <= p < self.cfg.n_pages:
                raise ValueError(f"freeing foreign page id {p}")
            if self._refs[p] < 1:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def free_seq(self, page_row: np.ndarray) -> None:
        self.decref(page_row)


class _PrefixEntry:
    __slots__ = ("pages", "n_tokens")

    def __init__(self, pages: list[int], n_tokens: int):
        self.pages = pages
        self.n_tokens = n_tokens


class PrefixCache:
    """Cross-request prefix cache (scheduler-thread owned, like its
    pool): the BYTES of a page-aligned prompt prefix -> the page ids
    holding those positions' K/V.  A hit aliases the shared pages into
    the new sequence's table and prefills only the suffix.  Entries hold
    their own refcount on every page; eviction is LRU under allocation
    pressure.  Sharing is sound only while slot == position (one ring
    lap): prompts longer than the window are neither cached nor
    matched."""

    def __init__(self, pool: PagePool, window: int):
        self.pool = pool
        self.window = int(window)
        self.page_size = int(pool.cfg.page_size)
        #: insertion-ordered = LRU order (move to the end on a hit)
        self._entries: dict[bytes, _PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_pages(self) -> int:
        """Distinct pages referenced by at least one entry."""
        return len({p for e in self._entries.values() for p in e.pages})

    def evictable_pages(self) -> int:
        """Pages that would return to the free list if every entry were
        evicted (held by entries only)."""
        held: dict[int, int] = {}
        for e in self._entries.values():
            for p in e.pages:
                held[p] = held.get(p, 0) + 1
        return sum(1 for p, n in held.items()
                   if self.pool.refcount(p) == n)

    def _max_pages(self, prompt_len: int) -> int:
        """Longest page-aligned PROPER prefix (one suffix token must
        remain: its logits seed the first generated token) inside one
        ring lap."""
        if prompt_len > self.window:
            return 0
        return (prompt_len - 1) // self.page_size

    def lookup(self, prompt: np.ndarray) -> _PrefixEntry | None:
        """Longest cached page-aligned proper prefix of ``prompt``
        (bumped to most recent), or None."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        for q in range(self._max_pages(prompt.shape[0]), 0, -1):
            key = prompt[:q * self.page_size].tobytes()
            e = self._entries.get(key)
            if e is not None:
                self._entries.pop(key)
                self._entries[key] = e
                self.hits += 1
                return e
        self.misses += 1
        return None

    def insert(self, prompt: np.ndarray, page_row: np.ndarray) -> int:
        """Register every page-aligned proper prefix of a just-prefilled
        prompt; each entry increfs its pages.  Returns entries added."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        added = 0
        for q in range(1, self._max_pages(prompt.shape[0]) + 1):
            key = prompt[:q * self.page_size].tobytes()
            if key in self._entries:
                continue
            pages = [int(p) for p in page_row[:q]]
            self.pool.incref(pages)
            self._entries[key] = _PrefixEntry(pages, q * self.page_size)
            added += 1
        return added

    def contains(self, prefix: np.ndarray) -> bool:
        """Exact-key membership (no LRU bump, no hit/miss count)."""
        prefix = np.asarray(prefix, np.int32).reshape(-1)
        return prefix.tobytes() in self._entries

    def insert_pages(self, prefix: np.ndarray, pages) -> int:
        """Register a page-aligned prefix whose own pages are given,
        its full length included (shipped cache content with no live
        sequence behind it), and every nested sub-prefix.  Returns
        entries added."""
        prefix = np.asarray(prefix, np.int32).reshape(-1)
        n = prefix.shape[0]
        ps = self.page_size
        if n < ps or n % ps or n > self.window:
            raise ValueError(
                f"insert_pages needs a page-aligned prefix of 1.."
                f"{self.window // ps} pages, got {n} tokens")
        pages = [int(p) for p in np.asarray(pages, np.int64).reshape(-1)]
        if len(pages) != n // ps:
            raise ValueError(f"{len(pages)} pages cannot hold {n} tokens "
                             f"at page_size {ps}")
        added = 0
        for q in range(1, n // ps + 1):
            key = prefix[:q * ps].tobytes()
            if key in self._entries:
                continue
            self.pool.incref(pages[:q])
            self._entries[key] = _PrefixEntry(list(pages[:q]), q * ps)
            added += 1
        return added

    def evict_lru(self) -> int:
        """Drop the least-recently-used entry; returns pages freed."""
        if not self._entries:
            return 0
        key = next(iter(self._entries))
        e = self._entries.pop(key)
        self.evictions += 1
        return self.pool.decref(e.pages)

    def evict_all(self) -> int:
        freed = 0
        while self._entries:
            freed += self.evict_lru()
        return freed
