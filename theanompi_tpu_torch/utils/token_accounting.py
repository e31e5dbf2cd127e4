"""Token-throughput accounting shared by training and serving bench.

``tools/bench_lm.py`` (training tokens/s) and ``tools/bench_serving.py
--decode`` (served tokens/s) must compute the SAME quantity the same
way, or a "serving reaches X% of training throughput" claim silently
compares different arithmetic.  One helper, one definition:

* a **token** is one position of one sequence that the model produced
  or trained on — for training, ``steps * global_batch * seq_len``
  (every position of every sequence gets a loss); for decode serving,
  the number of GENERATED tokens (prompt positions are prefill work,
  not output — they are counted separately by the prefill histogram);
* **tokens/s** divides by the measurement wall window;
* **tokens/s/chip** divides further by the participating chip count —
  the BASELINE.md comparison axis (r3: 157k tok/s/chip).

Speculative decoding adds a second axis the two benches must also
agree on (``speculative_accounting``): a served token is an EMITTED
token — the accepted draft prefix plus the verify step's own argmax —
so ``tokens`` above is unchanged by speculation; REJECTED draft
tokens are compute spent, never output, and are excluded from both
the throughput number and the inter-token SLO histogram (as is each
stream's first token, which is queue+prefill latency — see
``decode/scheduler.py _emit_token``).

Copy of ``theanompi_tpu/utils/token_accounting.py`` (JAX-free there too).
"""

from __future__ import annotations


def token_throughput(tokens: int, wall_s: float,
                     n_chips: int = 1) -> dict:
    """The canonical tokens/s record both bench tools embed.

    Returns ``{tokens, wall_s, tokens_per_sec, tokens_per_sec_per_chip,
    n_chips}`` — ``tokens_per_sec*`` are 0.0 for an empty window
    rather than a ZeroDivisionError (a bench that measured nothing
    should emit an honest zero, not crash after the run)."""
    tokens = int(tokens)
    wall_s = float(wall_s)
    n_chips = max(1, int(n_chips))
    rate = tokens / wall_s if wall_s > 0 else 0.0
    return {
        "tokens": tokens,
        "wall_s": wall_s,
        "n_chips": n_chips,
        "tokens_per_sec": rate,
        "tokens_per_sec_per_chip": rate / n_chips,
    }


def speculative_accounting(emitted: int, drafted: int,
                           accepted: int) -> dict:
    """The canonical speculative-decode record both the scheduler's
    ``stats()`` and ``bench_serving --decode`` embed.

    ``emitted`` — tokens actually produced (the throughput axis,
    identical to the non-speculative count for the same request);
    ``drafted`` — draft proposals made (k per sequence per round);
    ``accepted`` — proposals the verify step kept.  ``accept_rate`` is
    accepted/drafted (None before any speculation, not a fake 0.0)."""
    emitted, drafted = int(emitted), int(drafted)
    accepted = int(accepted)
    return {
        "emitted_tokens": emitted,
        "draft_tokens": drafted,
        "accepted_draft_tokens": accepted,
        "accept_rate": accepted / drafted if drafted else None,
    }
