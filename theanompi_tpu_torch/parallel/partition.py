"""Byte-balanced contiguous range partitioning.

Copy of ``theanompi_tpu/parallel/partition.py`` (the port imports
nothing of the JAX package): the one greedy walk behind every plan that
each rank must derive identically on its own, here the exchanger's
gradient buckets (``parallel/exchanger.py`` ``bucket_ranges``).  The plan
is a pure function of (sizes, k), so no plan ever travels between
ranks.
"""

from __future__ import annotations

from typing import Sequence


def balanced_ranges(sizes: Sequence[int], k: int) -> list[tuple[int, int]]:
    """Cut ``len(sizes)`` items into ``k`` contiguous ``(lo, hi)``
    ranges balanced by total size.

    Greedy walk: each range takes items while that brings its
    cumulative total closer to the i-th size quantile, always taking
    at least one item and leaving at least one for every range after
    it.  Requires ``1 <= k <= len(sizes)``; callers that want
    clamping (bucket plans) clamp before calling.
    """
    sizes = [int(s) for s in sizes]
    n, k = len(sizes), int(k)
    if k < 1:
        raise ValueError(f"need k >= 1 ranges, got {k}")
    if n == 0:
        raise ValueError("cannot partition an empty sequence")
    if k > n:
        raise ValueError(
            f"{k} ranges over {n} items — items are never split, so "
            "at most one range per item")
    total = sum(sizes)
    ranges: list[tuple[int, int]] = []
    lo, acc = 0, 0
    for i in range(k):
        hi = lo + 1
        acc += sizes[lo]
        cap = n - (k - i - 1)  # leave >= 1 item per remaining range
        target = total * (i + 1) / k
        while hi < cap:
            nxt = acc + sizes[hi]
            if abs(nxt - target) <= abs(acc - target):
                acc = nxt
                hi += 1
            else:
                break
        ranges.append((lo, hi))
        lo = hi
    if lo != n:
        raise AssertionError((ranges, n))
    return ranges
