"""TM201 — why the use-after-donate lint has no PyTorch counterpart.

The JAX check (``theanompi_tpu/analysis/donation.py``) tracks arrays
passed in a donated position of ``jax.jit(..., donate_argnums=...)``:
after the call XLA owns their buffers, and a later read from Python is
undefined (garbage or a crash on the TPU, often silently right on the
CPU).  PyTorch has no buffer donation: no call in the port hands a
tensor's storage to another owner while the Python name still refers
to it, and an in-place update (``p.add_(...)``, an optimizer's step)
leaves every reference valid.  There is no lexical class of call sites
to register, so the check has nothing to find.

The nearest PyTorch hazard is a CUDA tensor made on one stream and used
on another with no ordering: the caching allocator may hand its memory
out again while the other stream still reads it.  Its rule (the
consumer ``wait_stream``/``wait_event``s, then ``record_stream``s each
tensor) has two sites in the port, ``parallel/server.py``
``receive`` and ``data/prefetch.py``'s prefetcher ``__next__``,
both written to it and exercised on the card (``chip_smoke.py`` phases
21 and 23); they are too few and too unlike each other for a lexical
rule to hold them better than their tests do.

So ``CHECK_IDS`` keeps ``TM201`` (a JAX baseline key means the same
thing in both packages), :func:`run` reports nothing, and the CLI
prints :data:`WHY` instead of a count.
"""

from __future__ import annotations

from theanompi_tpu_torch.analysis.common import Finding, SourceFile

CHECK_ID = "TM201"

WHY = ("TM201 (use after donate) has no PyTorch counterpart: PyTorch "
       "has no buffer donation (theanompi_tpu_torch/analysis/donation.py)")


def run(files: list[SourceFile]) -> list[Finding]:
    """No findings: see the module docstring."""
    return []
