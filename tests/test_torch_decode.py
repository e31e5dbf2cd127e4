"""The port's decode path (theanompi_tpu_torch/decode) and quantized
exports on the CPU, held against the JAX package.

A small TransformerLM (2 layers, d_model 64, 4 heads, vocab 64) with the
same numpy weights on both sides (drawn from a seed, carried across by
``transformer_state_dict_from_flax``), f32 compute; a 1-layer d_model 16
draft over the same vocab for speculation.  The classes mirror JAX's
``tests/test_decode.py``:

* the ring math, the prompt ring, the page gather and the count-masked
  writes equal JAX's (the port writes dropped tokens to its drop page,
  which JAX's pool does not have: the live pages are compared);
* ``full_forward``, ``chunk_block`` and ``decode_block`` match JAX's
  within ``rtol=1e-4`` and a floor of ``1e-5 * max|want|`` (f32; the
  same operations, summed in other orders);
* the greedy tokens of the port's ``DecodeSession`` equal JAX's
  ``DecodeSession``'s, token for token, for plain, windowed (past the
  ring's eviction boundary), prefix-hit, copy-on-write, speculative,
  batched-prefill, adopted/migrated and int8/bf16 streams (the JAX
  reference sessions run without a prefix cache);
* the int8 and bf16 ``quantize_tree`` leaves are bit-identical to JAX's
  after the bridge;
* JAX's "steady state never recompiles" pins are restated: each program
  family records the bucket keys it has run, and a repeated workload
  adds none; the page tensors keep their ``data_ptr`` across every step.

The TCP front and the server's decode branch are in
``test_torch_serving_rpc.py``.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from theanompi_tpu.decode import DecodeSession as JaxSession
from theanompi_tpu.decode import kvcache as jkv
from theanompi_tpu.decode import model as jmodel
from theanompi_tpu.models.base import ModelConfig as JaxConfig
from theanompi_tpu.models.transformer import TransformerLM as JaxLM
from theanompi_tpu.models.transformer import TransformerLMNet as JaxNet
from theanompi_tpu.serving import export as jexport
from theanompi_tpu.utils import token_accounting as jta
from theanompi_tpu_torch.decode import (
    CacheConfig,
    ContinuousBatcher,
    DecodePolicy,
    DecodeReplica,
    DecodeSession,
    PagePool,
    full_forward,
)
from theanompi_tpu_torch.decode import kvcache
from theanompi_tpu_torch.decode import model as pmodel
from theanompi_tpu_torch.decode.scheduler import MigratedStream
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.bridge import (
    _FROM_FLAX,
    _transformer_param_leaves,
    transformer_state_dict_from_flax,
)
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving import (
    Overloaded,
    export_model,
    load_export,
)
from theanompi_tpu_torch.serving.export import (
    dequantize_tree,
    quantize_axes,
    quantize_tree,
)
from theanompi_tpu_torch.utils import token_accounting as pta

DIMS = dict(vocab=64, seq_len=16, n_layers=2, d_model=64, n_heads=4)
DRAFT_DIMS = dict(vocab=64, seq_len=16, n_layers=1, d_model=16, n_heads=1)
VOCAB = DIMS["vocab"]
pytestmark = pytest.mark.usefixtures("two_torch_threads")


def draw_params(dims: dict, seed: int) -> dict:
    """numpy flax ``params`` of a TransformerLMNet: matrices N(0,
    1/fan_in), tables N(0, 0.5^2), LayerNorm scales 1 + N(0, 0.1^2),
    other vectors N(0, 0.1^2) (well-separated logits: no argmax
    near-ties)."""
    net = JaxNet(d_ff=4 * dims["d_model"], max_len=2048,
                 **{k: dims[k] for k in ("vocab", "n_layers", "d_model",
                                         "n_heads")})
    shapes = jax.eval_shape(net.init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        elif name in ("embedding", "pos_emb"):
            v = 0.5 * rng.standard_normal(leaf.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes["params"]))


class Pair:
    """The same LM on both sides: the JAX model and params, the port
    model with the bridged weights."""

    def __init__(self, dims: dict, seed: int):
        self.params = draw_params(dims, seed)
        self.jax = JaxLM(config=JaxConfig(batch_size=4, n_epochs=1,
                                          print_freq=0,
                                          compute_dtype="float32"),
                         verbose=False, **dims)
        self.port = TransformerLM(config=ModelConfig(
            batch_size=4, n_epochs=1, print_freq=0,
            compute_dtype="float32"), device="cpu", **dims)
        self.state = transformer_state_dict_from_flax(self.params)
        self.port.module.load_state_dict(self.state)
        self._jax_sessions: dict = {}
        self._memo: dict = {}

    def session(self, **kw) -> DecodeSession:
        return DecodeSession(self.port, **kw)

    def jax_session(self, page_size: int, pages_per_seq: int,
                    buckets: tuple, params=None, max_seqs: int = 4):
        """A cached JAX reference session (no prefix cache)."""
        key = (page_size, pages_per_seq, buckets, max_seqs,
               None if params is None else id(params))
        if key not in self._jax_sessions:
            self._jax_sessions[key] = JaxSession(
                self.jax, params=self.params if params is None else params,
                page_size=page_size, pages_per_seq=pages_per_seq,
                max_seqs=max_seqs, prefill_buckets=buckets,
                prefix_cache=False)
        return self._jax_sessions[key]

    def jax_greedy(self, prompt, n: int, page_size: int = 4,
                   pages_per_seq: int = 8, buckets=(8, 16)) -> list[int]:
        key = (np.asarray(prompt, np.int32).tobytes(), n, page_size,
               pages_per_seq, buckets)
        if key not in self._memo:
            self._memo[key] = greedy(self.jax_session(
                page_size, pages_per_seq, buckets), prompt, n)
        return self._memo[key]


@pytest.fixture(scope="module")
def lm():
    return Pair(DIMS, seed=1)


@pytest.fixture(scope="module")
def draft():
    return Pair(DRAFT_DIMS, seed=2)


def greedy(sess, prompt, n: int) -> list[int]:
    seq, logits = sess.admit(np.asarray(prompt, np.int32))
    out = [int(np.argmax(logits))]
    for _ in range(n - 1):
        lg = sess.decode([seq], np.asarray([out[-1]], np.int32))
        out.append(int(np.argmax(lg[0])))
    sess.release(seq)
    return out


def spec_greedy(sess, dsess, prompt, n: int, k: int = 3) -> list[int]:
    seq, logits = sess.admit(np.asarray(prompt, np.int32))
    dseq, _ = dsess.admit(np.asarray(prompt, np.int32))
    out = [int(np.argmax(logits))]
    while len(out) < n:
        pending = np.asarray([out[-1]], np.int32)
        drafts = dsess.propose([dseq], pending, k)
        y, counts = sess.verify([seq], pending, drafts)
        dsess.commit([dseq], counts)
        out.extend(int(t) for t in y[0, :counts[0]])
    sess.release(seq)
    dsess.release(dseq)
    return out[:n]


def port_windowed_greedy(lm, prompt, n: int, window: int) -> list[int]:
    """The eviction oracle on the port: iterative full forward under
    the sliding-window mask."""
    cur = [int(t) for t in prompt]
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits, _, _ = full_forward(lm.port.module,
                                        torch.tensor([cur]), window)
            out.append(int(logits[0, -1].argmax()))
            cur.append(out[-1])
    return out


def prompts(seed: int, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, t).astype(np.int32) for t in lens]


def live_pages(pages: torch.Tensor) -> np.ndarray:
    """The pool without the port's drop page."""
    return pages[:, :-1].numpy()


# ---------------------------------------------------------------------------
# kvcache.py
# ---------------------------------------------------------------------------


class TestKVCache:
    @pytest.mark.parametrize("lengths", [[0, 3, 6], [1, 8, 13, 30]])
    def test_ring_math_equals_jax(self, lengths):
        w = 8
        lt, lj = torch.tensor(lengths), jnp.asarray(lengths, jnp.int32)
        np.testing.assert_array_equal(
            kvcache.stored_positions(lt, w).numpy(),
            np.asarray(jkv.stored_positions(lj, w)))
        np.testing.assert_array_equal(kvcache.cache_mask(lt, w).numpy(),
                                      np.asarray(jkv.cache_mask(lj, w)))
        np.testing.assert_array_equal(
            kvcache.chunk_cache_mask(lt, 4, w).numpy(),
            np.asarray(jkv.chunk_cache_mask(lj, 4, w)))

    def test_stored_positions_and_mask(self):
        w = 4
        pos = kvcache.stored_positions(torch.tensor([6]), w)[0]
        assert pos.tolist() == [4, 5, 2, 3]
        mask = kvcache.cache_mask(torch.tensor([6]), w)[0]
        assert mask.tolist() == [True, True, False, True]
        assert not kvcache.cache_mask(torch.tensor([0]), w).any()

    @pytest.mark.parametrize("length", [2, 6, 9])
    def test_ring_from_prompt_equals_jax(self, length):
        kv = np.random.default_rng(length).standard_normal(
            (12, 2, 3)).astype(np.float32)
        want = np.asarray(jkv.ring_from_prompt(jnp.asarray(kv), length, 4))
        got = kvcache.ring_from_prompt(torch.from_numpy(kv), length, 4)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_gather_and_writes_equal_jax(self):
        """One layer's gather, then a count-masked write: counts 0
        (a padding row), partial, and past the window (only the last
        ``window`` positions survive); the port's live pages equal
        JAX's pool, the drop page aside."""
        cfg = CacheConfig(n_layers=2, n_heads=2, d_head=3, page_size=2,
                          pages_per_seq=3, max_seqs=3)
        rng = np.random.default_rng(7)
        k, _ = kvcache.init_pages(cfg)
        k[:, :-1] = torch.from_numpy(rng.standard_normal(
            k[:, :-1].shape).astype(np.float32))
        jk = jnp.asarray(live_pages(k))
        rows = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
        np.testing.assert_array_equal(
            kvcache.gather_layer(k[1], torch.from_numpy(rows).long())
            .numpy(), np.asarray(jkv.gather_layer(jk[1], rows)))
        lengths = np.asarray([3, 5, 0], np.int32)
        counts = np.asarray([0, 2, 8], np.int32)
        new = rng.standard_normal((2, 3, 8, 2, 3)).astype(np.float32)
        want = np.asarray(jkv.write_tokens_all(
            jk, jnp.asarray(rows), jnp.asarray(lengths),
            jnp.asarray(counts), jnp.asarray(new)))
        ptr = k.data_ptr()
        kvcache.write_tokens_all(k, torch.from_numpy(rows).long(),
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(counts),
                                 torch.from_numpy(new))
        np.testing.assert_array_equal(live_pages(k), want)
        assert k.data_ptr() == ptr
        active = np.asarray([True, False, True])
        tok = rng.standard_normal((2, 3, 2, 3)).astype(np.float32)
        want = np.asarray(jkv.write_token_all(
            jnp.asarray(want), jnp.asarray(rows), jnp.asarray(lengths),
            jnp.asarray(active), jnp.asarray(tok)))
        kvcache.write_token_all(k, torch.from_numpy(rows).long(),
                                torch.from_numpy(lengths),
                                torch.from_numpy(active),
                                torch.from_numpy(tok))
        np.testing.assert_array_equal(live_pages(k), want)

    def test_page_pool_alloc_free(self):
        cfg = CacheConfig(n_layers=1, n_heads=1, d_head=4, page_size=2,
                          pages_per_seq=2, max_seqs=2)
        pool = PagePool(cfg)
        a, b = pool.alloc_seq(), pool.alloc_seq()
        assert pool.alloc_seq() is None and pool.used_fraction == 1.0
        pool.free_seq(a)
        with pytest.raises(ValueError):
            pool.free_seq(a)
        pool.free_seq(b)
        assert sorted(np.concatenate([a, b]).tolist()) == [0, 1, 2, 3]
        k, v = kvcache.init_pages(cfg)
        assert k.shape == (1, cfg.n_pages + 1, 2, 1, 4) == v.shape


# ---------------------------------------------------------------------------
# model.py
# ---------------------------------------------------------------------------


class TestFullForward:
    @pytest.mark.parametrize("window", [None, 8])
    def test_matches_jax(self, lm, window):
        toks = prompts(0, 20)[0][None]
        lj, kj, vj = jmodel.full_forward(lm.params, jnp.asarray(toks), 2, 4,
                                         jnp.float32, window=window)
        with torch.no_grad():
            lp, kp, vp = full_forward(lm.port.module, torch.from_numpy(toks),
                                      window)
        assert_close(lp.numpy(), np.asarray(lj))
        for a, b in zip(kp + vp, list(kj) + list(vj)):
            assert_close(a.numpy(), np.asarray(b))

    def test_matches_training_module(self, lm):
        toks = torch.from_numpy(prompts(1, 12)[0][None])
        with torch.no_grad():
            want = lm.port.module.eval()(toks)
            got, _, _ = full_forward(lm.port.module, toks)
            short, _, _ = full_forward(lm.port.module, toks, window=12)
        assert_close(got.numpy(), want.numpy())
        assert torch.equal(got, short)

    def test_chunk_and_decode_block_match_jax(self, lm):
        rng = np.random.default_rng(3)
        s, c, w, h, dh = 3, 4, 8, 4, 16
        x = rng.standard_normal((s, c, 64)).astype(np.float32)
        kc = rng.standard_normal((s, w, h, dh)).astype(np.float32)
        vc = rng.standard_normal((s, w, h, dh)).astype(np.float32)
        lengths = np.asarray([0, 5, 11], np.int32)
        ring = np.array(jkv.chunk_cache_mask(jnp.asarray(lengths), c, w))
        bp = lm.params["Block_1"]
        block = lm.port.module.blocks[1]
        want = jmodel.chunk_block(bp, jnp.asarray(x), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(ring), 4,
                                  jnp.float32, window=w)
        with torch.no_grad():
            got = pmodel.chunk_block(block, torch.from_numpy(x),
                                     torch.from_numpy(kc),
                                     torch.from_numpy(vc),
                                     torch.from_numpy(ring), window=w)
        for a, b in zip(got, want):
            assert_close(a.numpy(), np.asarray(b))
        mask = ring[:, 0]
        want = jmodel.decode_block(bp, jnp.asarray(x[:, :1]),
                                   jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(mask), 4, jnp.float32)
        with torch.no_grad():
            got = pmodel.decode_block(block, torch.from_numpy(x[:, :1]),
                                      torch.from_numpy(kc),
                                      torch.from_numpy(vc),
                                      torch.from_numpy(mask))
        for a, b in zip(got, want):
            assert_close(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# session.py
# ---------------------------------------------------------------------------


class TestGreedyIdentity:
    def test_token_identical_per_prefill_bucket(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=2,
                          prefill_buckets=(8, 16), prefix_cache=False)
        for p in prompts(2, 5, 12):
            assert greedy(sess, p, 6) == lm.jax_greedy(p, 6)
        assert {k: v for k, v in sess.compiles.items() if v} == {
            "prefill": 2, "decode": 1}

    def test_token_identical_across_eviction_boundary(self, lm):
        """window 8: a 5-token prompt + 10 tokens crosses the ring
        boundary, a 12-token prompt overflows it alone; equal to JAX's
        session and to the port's sliding-window oracle."""
        for p in prompts(3, 5, 12):
            sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                              prefill_buckets=(8, 16), prefix_cache=False)
            assert sess.window == 8
            got = greedy(sess, p, 10)
            assert got == lm.jax_greedy(p, 10, pages_per_seq=2)
            assert got == port_windowed_greedy(lm, p, 10, 8)

    def test_batched_decode_matches_sequential(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=4,
                          prefill_buckets=(8,))
        pa, pb = prompts(4, 4, 7)
        sa, la = sess.admit(pa)
        sb, lb = sess.admit(pb)
        oa, ob = [int(np.argmax(la))], [int(np.argmax(lb))]
        for _ in range(5):
            lg = sess.decode([sa, sb], np.asarray([oa[-1], ob[-1]]))
            oa.append(int(np.argmax(lg[0])))
            ob.append(int(np.argmax(lg[1])))
        assert oa == lm.jax_greedy(pa, 6, buckets=(8,))
        assert ob == lm.jax_greedy(pb, 6, buckets=(8,))


class TestRestatedPins:
    """JAX's ``TestCompileCounter``, restated: no new bucket key in
    steady state, and the pool written in place."""

    def test_steady_state_adds_no_bucket_key(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                          prefill_buckets=(8,))
        ptrs = [t.data_ptr() for t in sess.page_tensors]
        rng = np.random.default_rng(5)

        def cycle():
            a, la = sess.admit(rng.integers(0, VOCAB, 3).astype(np.int32))
            ta = int(np.argmax(la))
            sess.decode([a], np.asarray([ta]))
            b, lb = sess.admit(rng.integers(0, VOCAB, 6).astype(np.int32))
            tb = int(np.argmax(lb))
            for _ in range(6):  # crosses the window-8 boundary
                lg = sess.decode([a, b], np.asarray([ta, tb]))
                ta, tb = int(np.argmax(lg[0])), int(np.argmax(lg[1]))
            sess.release(a)
            sess.decode([b], np.asarray([tb]))
            sess.release(b)

        cycle()
        warm = {f: set(k) for f, k in sess.bucket_keys.items()}
        assert sess.compiles["prefill"] == 1 and sess.compiles["decode"] == 2
        for _ in range(3):
            cycle()
        assert sess.bucket_keys == warm
        assert [t.data_ptr() for t in sess.page_tensors] == ptrs
        sess.reset_cache()
        assert [t.data_ptr() for t in sess.page_tensors] == ptrs

    def test_warmups_cover_the_replica_families(self, lm, draft):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=4,
                          prefill_buckets=(8,))
        sess.warmup()
        sess.warmup_prefill_batch()
        sess.warmup_spec(3, "target")
        dsess = draft.session(page_size=4, pages_per_seq=2, max_seqs=4,
                              prefill_buckets=(8,))
        dsess.warmup()
        dsess.warmup_spec(3, "draft")
        assert sess.pool.free_pages == sess.cfg.n_pages
        assert {f for f, n in sess.compiles.items() if n} == {
            "prefill", "decode", "extend", "cow_copy", "adopt",
            "prefill_batch", "verify"}
        assert dsess.compiles["propose"] == dsess.compiles["commit"] == 1
        # warmup writes only the drop page
        assert not sess.page_tensors[0][:, :-1].any()
        with pytest.raises(ValueError, match="role"):
            sess.warmup_spec(3, "other")


# ---------------------------------------------------------------------------
# scheduler.py
# ---------------------------------------------------------------------------


class TestContinuousBatcher:
    def test_mid_stream_admit_shares_step_and_stays_correct(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=4,
                          prefill_buckets=(8,))
        batcher = ContinuousBatcher(sess, DecodePolicy(max_pending=8),
                                    replica=0).start()
        try:
            pa, pb = prompts(6, 4, 6)
            results = {}

            def run(name, prompt, n):
                results[name] = batcher.generate(prompt, n)

            ta = threading.Thread(target=run, args=("a", pa, 24))
            tb = threading.Thread(target=run, args=("b", pb, 12))
            ta.start()
            tb.start()
            ta.join(60)
            tb.join(60)
            assert results["a"] == lm.jax_greedy(pa, 24, buckets=(8,))
            assert results["b"] == lm.jax_greedy(pb, 12, buckets=(8,))
            st = batcher.stats()
            assert st["shared_steps"] >= 1, st
            assert st["evicted"] == 2 and st["active"] == 0
            assert sess.pool.free_pages \
                + sess.prefix_cache.cached_pages == sess.cfg.n_pages
        finally:
            batcher.stop()

    def test_admission_overload_is_typed_and_o1(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                          prefill_buckets=(8,))
        batcher = ContinuousBatcher(sess, DecodePolicy(max_pending=1),
                                    replica=0)
        errs = []

        def bg():
            try:
                batcher.generate(np.asarray([1, 2, 3], np.int32), 4)
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=bg)
        t.start()
        for _ in range(50):
            if batcher.stats()["pending"] >= 1:
                break
            time.sleep(0.02)
        with pytest.raises(Overloaded):
            batcher.generate(np.asarray([1, 2, 3], np.int32), 4)
        batcher.stop()
        t.join(10)
        assert len(errs) == 1 and isinstance(errs[0], Overloaded)

    def test_decode_step_fault_restarts_from_export(self, lm, tmp_path):
        """A ``decode_step`` fault fails that step's stream; the replica
        restarts from the version it serves (not a newer int8 publish)
        on zeroed pages and serves the next stream as JAX's session."""
        export_dir = str(tmp_path / "export")
        export_model(lm.port, export_dir, version=0)
        export_model(lm.port, export_dir, version=1, weight_dtype="int8")
        loaded = load_export(export_dir, version=0)
        rep = DecodeReplica(0, export_dir, lm.port, loaded,
                            DecodePolicy(max_pending=4), max_restarts=1,
                            page_size=4, pages_per_seq=8, max_seqs=4,
                            prefill_buckets=(8,))
        rep.batcher.start()
        faults.install([{"site": "decode_step", "replica": 0, "step": 2}])
        try:
            (prompt,) = prompts(9, 5)
            with pytest.raises(faults.FaultInjected):
                rep.generate(prompt, 8)
            assert rep.restarts == 1 and rep.alive
            assert rep.session.version == 0
            assert rep.generate(prompt, 6) == lm.jax_greedy(
                prompt, 6, buckets=(8,))
        finally:
            faults.clear()
            rep.batcher.stop()

    def test_request_validation(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                          prefill_buckets=(8,))
        batcher = ContinuousBatcher(
            sess, DecodePolicy(max_new_cap=sess.max_len + 8,
                               submit_timeout_s=5.0), replica=0)
        with pytest.raises(ValueError):
            batcher.generate(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError):
            batcher.generate(np.zeros((9,), np.int32), 4)
        with pytest.raises(ValueError):
            batcher.generate(np.asarray([1], np.int32), sess.max_len + 1)
        batcher.stop()


# ---------------------------------------------------------------------------
# Quantized exports
# ---------------------------------------------------------------------------


def _flat_jax(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if jexport.is_quantized_leaf(v) or not isinstance(v, dict):
            out[pre + k] = v
        else:
            out.update(_flat_jax(v, pre + k + "/"))
    return out


class TestQuantizedExports:
    @pytest.mark.parametrize("wd", ["int8", "bf16"])
    def test_leaves_bit_identical_to_jax_after_bridge(self, lm, wd):
        got = quantize_tree(lm.state, wd, quantize_axes(lm.port.module))
        want = _flat_jax(jexport.quantize_tree(lm.params, wd))
        for port, path, layout in _transformer_param_leaves(2):
            w, g = want[path], got[port]
            if isinstance(w, dict):
                for key, dt in (("int8_data", torch.int8),
                                ("int8_scale", torch.float32)):
                    assert g[key].dtype == dt
                    np.testing.assert_array_equal(
                        g[key].numpy(),
                        _FROM_FLAX[layout](np.asarray(w[key])))
            elif wd == "bf16" and np.asarray(w).ndim >= 2:
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    g.view(torch.int16).numpy(),
                    _FROM_FLAX[layout](np.asarray(w).view(np.int16)))
            else:
                np.testing.assert_array_equal(
                    g.numpy(), _FROM_FLAX[layout](np.asarray(w)))
        deq = dequantize_tree(got, upcast_bf16=True)
        jdeq = transformer_state_dict_from_flax(
            jexport.dequantize_tree(jexport.quantize_tree(lm.params, wd),
                                    upcast_bf16=True))
        for k in jdeq:
            assert torch.equal(deq[k], jdeq[k]), k

    def test_quantized_export_load_and_meta(self, lm, tmp_path):
        for wd in ("bf16", "int8"):
            d = str(tmp_path / f"export_{wd}")
            export_model(lm.port, d, version=0, weight_dtype=wd)
            loaded = load_export(d)
            assert loaded.meta["weight_dtype"] == wd
            assert loaded.meta["decode"] is True
            assert all(t.dtype == torch.float32
                       for t in loaded.state.values())
            raw = load_export(d, dequantize=False)
            kinds = {str(v["int8_data"].dtype) if isinstance(v, dict)
                     else str(v.dtype) for v in raw.state.values()}
            assert ("torch.int8" in kinds) if wd == "int8" \
                else ("torch.bfloat16" in kinds)
        with pytest.raises(ValueError, match="weight_dtype"):
            export_model(lm.port, str(tmp_path / "x"), weight_dtype="fp8")

    @pytest.mark.parametrize("wd", ["int8", "bf16"])
    def test_quantized_greedy_equals_jax(self, lm, tmp_path, wd):
        """The port's session on the export loaded both ways (collapsed
        at load; int8/bf16 kept on the device and dequantized inside
        each step) gives JAX's session's tokens on JAX's dequantized
        tree of the same quantization."""
        d = str(tmp_path / "export")
        export_model(lm.port, d, version=0, weight_dtype=wd)
        jparams = jexport.dequantize_tree(
            jexport.quantize_tree(lm.params, wd), upcast_bf16=True)
        (prompt,) = prompts(7, 5)
        want = greedy(lm.jax_session(4, 8, (8,), params=jparams), prompt, 8)
        for dequantize in (True, False):
            loaded = load_export(d, dequantize=dequantize)
            sess = DecodeSession(lm.port, params=loaded.state, page_size=4,
                                 pages_per_seq=8, max_seqs=2,
                                 prefill_buckets=(8,))
            assert greedy(sess, prompt, 8) == want, dequantize
            if not dequantize:
                kept = sess._live[1][1]
                assert any(isinstance(v, dict) or v.dtype == torch.bfloat16
                           for v in kept.values())


# ---------------------------------------------------------------------------
# Refcounted pool + prefix cache
# ---------------------------------------------------------------------------


class TestRefcountedPagePool:
    def test_incref_decref_and_free_list(self):
        cfg = CacheConfig(n_layers=1, n_heads=1, d_head=4, page_size=2,
                          pages_per_seq=2, max_seqs=2)
        pool = PagePool(cfg)
        row = pool.alloc_seq()
        pool.incref(row)
        assert all(pool.refcount(int(p)) == 2 for p in row)
        pool.free_seq(row)
        assert pool.free_pages == 2
        assert pool.decref(row) == 2 and pool.free_pages == 4
        with pytest.raises(ValueError):
            pool.decref(row)
        with pytest.raises(ValueError):
            pool.incref([int(row[0])])
        with pytest.raises(ValueError):
            pool.incref([cfg.n_pages + 1])

    def test_prefix_cache_longest_match_and_lru(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                          prefill_buckets=(8,))
        pc = sess.prefix_cache
        p, other = prompts(11, 8, 8)
        seq, _ = sess.admit(p)
        assert len(pc) == 1 and pc.misses == 1
        hit = pc.lookup(np.concatenate([p[:4], p[:1]]))
        assert hit is not None and hit.n_tokens == 4
        assert pc.lookup(other) is None
        assert pc.lookup(np.tile(p, 2)) is None
        sess.release(seq)
        assert pc.evict_lru() >= 1
        assert sess.pool.free_pages == sess.cfg.n_pages


def _decode_two(sess, sa, sb, la, lb, n):
    oa, ob = [int(np.argmax(la))], [int(np.argmax(lb))]
    for _ in range(n - 1):
        lg = sess.decode([sa, sb], np.asarray([oa[-1], ob[-1]]))
        oa.append(int(np.argmax(lg[0])))
        ob.append(int(np.argmax(lg[1])))
    return oa, ob


class TestPrefixSharing:
    def test_hit_aliases_pages_and_equals_jax(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=4,
                          prefill_buckets=(8, 16))
        base, ta, tb = prompts(12, 4, 2, 3)
        pa, pb = np.concatenate([base, ta]), np.concatenate([base, tb])
        sa, la = sess.admit(pa)
        sb, lb = sess.admit(pb)
        assert sess.prefix_cache.hits == 1
        assert int(sa.page_row[0]) == int(sb.page_row[0])
        oa, ob = _decode_two(sess, sa, sb, la, lb, 8)
        assert oa == lm.jax_greedy(pa, 8)
        assert ob == lm.jax_greedy(pb, 8)

    def test_cow_divergence_across_ring_wrap(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=4,
                          prefill_buckets=(8,))
        base, tail = prompts(13, 5, 2)
        pa, pb = base, np.concatenate([base[:4], tail])
        sa, la = sess.admit(pa)
        sb, lb = sess.admit(pb)
        assert int(sa.page_row[0]) == int(sb.page_row[0])
        oa, ob = _decode_two(sess, sa, sb, la, lb, 12)
        assert oa == lm.jax_greedy(pa, 12, pages_per_seq=2, buckets=(8,))
        assert ob == lm.jax_greedy(pb, 12, pages_per_seq=2, buckets=(8,))
        assert sess.cow_copies >= 2
        assert int(sa.page_row[0]) != int(sb.page_row[0])

    def test_shared_page_outlives_first_owner(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=2,
                          prefill_buckets=(8, 16))
        base, ta, tb = prompts(14, 4, 1, 2)
        sa, _ = sess.admit(np.concatenate([base, ta]))
        sess.release(sa)
        assert sess.pool.free_pages < sess.cfg.n_pages
        pb = np.concatenate([base, tb])
        assert greedy(sess, pb, 6) == lm.jax_greedy(pb, 6)
        assert sess.prefix_cache.hits == 1
        sess.prefix_cache.evict_all()
        assert sess.pool.free_pages == sess.cfg.n_pages

    def test_allocation_pressure_evicts_lru_entries(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=4,
                          prefill_buckets=(8,))
        for p in prompts(15, *[6] * 12):
            s, _ = sess.admit(p)
            sess.release(s)
            assert sess.can_admit()
            assert sess.pool.free_pages \
                + sess.prefix_cache.cached_pages == sess.cfg.n_pages
        assert sess.prefix_cache.evictions >= 1

    def test_no_new_bucket_keys_with_sharing(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=4,
                          prefill_buckets=(8,))
        rng = np.random.default_rng(16)

        def cycle():
            base = rng.integers(0, VOCAB, 5).astype(np.int32)
            pb = np.concatenate(
                [base[:4], rng.integers(0, VOCAB, 2).astype(np.int32)])
            sa, la = sess.admit(base)
            sb, lb = sess.admit(pb)
            _decode_two(sess, sa, sb, la, lb, 11)
            sess.release(sa)
            sess.release(sb)

        cycle()
        warm = {f: set(k) for f, k in sess.bucket_keys.items()}
        assert sess.compiles["extend"] == 1 and sess.compiles["cow_copy"] == 1
        for _ in range(2):
            cycle()
        assert sess.bucket_keys == warm


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------


class TestSpeculative:
    def test_full_accept_token_identity(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=2,
                          prefill_buckets=(8,))
        dsess = lm.session(page_size=4, pages_per_seq=8, max_seqs=2,
                           prefill_buckets=(8,))
        (prompt,) = prompts(17, 5)
        assert spec_greedy(sess, dsess, prompt, 12) == lm.jax_greedy(
            prompt, 12, buckets=(8,))

    def test_accept_reject_boundaries_equal_jax(self, lm, draft):
        """A small random draft rejects at every depth: the port's
        rounds give JAX's speculative tokens (and the plain ones), and
        a repeated workload adds no bucket key."""
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=2,
                          prefill_buckets=(8,))
        dsess = draft.session(page_size=4, pages_per_seq=8, max_seqs=2,
                              prefill_buckets=(8,))
        jt = lm.jax_session(4, 8, (8,))
        jd = draft.jax_session(4, 8, (8,))
        for i, p in enumerate(prompts(18, 3, 7, 6)):
            got = spec_greedy(sess, dsess, p, 10)
            assert got == spec_greedy(jt, jd, p, 10)
            assert got == lm.jax_greedy(p, 10, buckets=(8,))
            if i == 0:
                warm = ({f: set(k) for f, k in sess.bucket_keys.items()},
                        {f: set(k) for f, k in dsess.bucket_keys.items()})
        assert (sess.bucket_keys, dsess.bucket_keys) == warm

    def test_identity_across_eviction_boundary(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                          prefill_buckets=(8,))
        dsess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                           prefill_buckets=(8,))
        (prompt,) = prompts(19, 5)
        assert spec_greedy(sess, dsess, prompt, 14) == lm.jax_greedy(
            prompt, 14, pages_per_seq=2, buckets=(8,))

    def test_batcher_speculates_with_shared_prefix(self, lm, draft):
        sess = lm.session(page_size=4, pages_per_seq=8, max_seqs=4,
                          prefill_buckets=(8,))
        dsess = draft.session(page_size=4, pages_per_seq=8, max_seqs=4,
                              prefill_buckets=(8,))
        batcher = ContinuousBatcher(
            sess, DecodePolicy(max_pending=8, speculate_k=3),
            replica=0, draft_session=dsess).start()
        try:
            base, ta, tb = prompts(23, 4, 1, 2)
            pa, pb = np.concatenate([base, ta]), np.concatenate([base, tb])
            results = {}

            def run(name, prompt, n):
                results[name] = batcher.generate(prompt, n)

            ths = [threading.Thread(target=run, args=("a", pa, 17)),
                   threading.Thread(target=run, args=("b", pb, 9))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
            assert results["a"] == lm.jax_greedy(pa, 17, buckets=(8,))
            assert results["b"] == lm.jax_greedy(pb, 9, buckets=(8,))
            st = batcher.stats()
            spec = st["speculation"]
            assert spec["draft_tokens"] > 0 and spec["accept_rate"] is not None
            assert st["tokens"] == 17 + 9 and st["steps"] < st["tokens"]
            assert st["prefix_cache"]["hits"] >= 1
            assert st["evicted"] == 2 and st["active"] == 0
        finally:
            batcher.stop()

    def test_speculate_k_validation(self, lm):
        sess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                          prefill_buckets=(8,))
        dsess = lm.session(page_size=4, pages_per_seq=2, max_seqs=2,
                           prefill_buckets=(8,))
        with pytest.raises(ValueError, match="speculate_k"):
            ContinuousBatcher(sess, DecodePolicy(speculate_k=8), replica=0,
                              draft_session=dsess)


class TestTokenAccounting:
    @pytest.mark.parametrize("tokens,wall,chips", [
        (0, 0.0, 1), (100, 2.5, 1), (7, 0.125, 4), (3, -1.0, 0),
        (10 ** 6, 3.0, 8)])
    def test_token_throughput_equals_jax(self, tokens, wall, chips):
        assert pta.token_throughput(tokens, wall, chips) == \
            jta.token_throughput(tokens, wall, chips)

    @pytest.mark.parametrize("emitted,drafted,accepted", [
        (0, 0, 0), (26, 18, 12), (5, 4, 4), (9, 12, 0)])
    def test_speculative_accounting_equals_jax(self, emitted, drafted,
                                               accepted):
        assert pta.speculative_accounting(emitted, drafted, accepted) == \
            jta.speculative_accounting(emitted, drafted, accepted)


# ---------------------------------------------------------------------------
# Batched prefill
# ---------------------------------------------------------------------------


class TestBatchedPrefill:
    def _session(self, lm, **over):
        opts = dict(page_size=4, pages_per_seq=4, max_seqs=4,
                    prefill_buckets=(4, 8))
        opts.update(over)
        return lm.session(**opts)

    def test_batch_identity_equals_jax_and_no_new_keys(self, lm):
        sess = self._session(lm, prefix_cache=False)
        sess.warmup()
        sess.warmup_prefill_batch()
        warm = {f: set(sess.bucket_keys[f])
                for f in ("prefill", "prefill_batch", "extend")}
        for seed, lens in enumerate(((3,), (4, 5), (3, 4, 8),
                                     (2, 4, 5, 8))):
            ps = prompts(30 + seed, *lens)
            admitted = sess.admit_batch(ps)
            seqs = [s for s, _ in admitted]
            outs = [[int(np.argmax(lg))] for _, lg in admitted]
            for _ in range(3):
                lg = sess.decode(seqs, np.asarray([o[-1] for o in outs]))
                for i, o in enumerate(outs):
                    o.append(int(np.argmax(lg[i])))
            for p, o in zip(ps, outs):
                assert o == lm.jax_greedy(p, 4, pages_per_seq=4,
                                          buckets=(4, 8))
            for s in seqs:
                sess.release(s)
        for fam, keys in warm.items():
            assert sess.bucket_keys[fam] == keys, fam

    def test_mixed_cold_and_hit_rows_share_pages(self, lm):
        sess = self._session(lm)
        base, t1, t2, cold = prompts(31, 4, 1, 2, 6)
        seed, _ = sess.admit(np.concatenate([base, t1]))
        ph = np.concatenate([base, t2])
        (sh, lh), (sc, lc) = sess.admit_batch([ph, cold])
        assert sess.prefix_cache.hits == 1
        assert int(sh.page_row[0]) == int(seed.page_row[0])
        assert int(sc.page_row[0]) != int(seed.page_row[0])
        oh, oc = _decode_two(sess, sh, sc, lh, lc, 6)
        assert oh == lm.jax_greedy(ph, 6, pages_per_seq=4, buckets=(4, 8))
        assert oc == lm.jax_greedy(cold, 6, pages_per_seq=4, buckets=(4, 8))

    def test_cow_when_two_batch_rows_share_a_page(self, lm):
        sess = self._session(lm, pages_per_seq=2, prefill_buckets=(8,))
        base, t1, t2 = prompts(32, 5, 1, 2)
        seed, _ = sess.admit(base)
        sess.release(seed)
        pa = np.concatenate([base[:4], t1])
        pb = np.concatenate([base[:4], t2])
        (sa, la), (sb, lb) = sess.admit_batch([pa, pb])
        assert sess.pool.refcount(int(sa.page_row[0])) == 3
        oa, ob = _decode_two(sess, sa, sb, la, lb, 12)
        assert oa == lm.jax_greedy(pa, 12, pages_per_seq=2, buckets=(8,))
        assert ob == lm.jax_greedy(pb, 12, pages_per_seq=2, buckets=(8,))
        assert sess.cow_copies >= 2

    def test_failed_batch_leaks_no_pages(self, lm):
        sess = self._session(lm)
        free0 = sess.pool.free_pages
        good, bad = prompts(35, 5, 9)
        with pytest.raises(ValueError, match="prompt length"):
            sess.admit_batch([good, bad])
        assert sess.pool.free_pages == free0


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------


class TestDrainMigration:
    def test_drained_stream_resumes_byte_identical(self, lm):
        def mk():
            return lm.session(page_size=4, pages_per_seq=4, max_seqs=2,
                              prefill_buckets=(8,))

        (prompt,) = prompts(34, 3)
        ref = lm.jax_greedy(prompt, 13, pages_per_seq=4, buckets=(8,))
        b = ContinuousBatcher(mk(), DecodePolicy(max_pending=4,
                                                 prefill_delay_ms=0.0))
        res = {}
        t = threading.Thread(
            target=lambda: res.setdefault("out", b.generate(prompt, 13)))
        t.start()
        for _ in range(2000):
            if b._pending:
                break
            time.sleep(0.002)
        b._admit()
        for _ in range(3):
            b._step()
        b._draining = True
        b._migrate_out()
        t.join(30)
        out = res["out"]
        assert isinstance(out, MigratedStream)
        assert out.tokens == ref[:3]
        assert out.manifest["first_token"] == ref[3]
        with pytest.raises(Overloaded, match="draining"):
            b.generate(prompt, 2)
        assert b.stats()["drain_migrated"] == 1
        survivor = ContinuousBatcher(mk(), DecodePolicy(max_pending=4)).start()
        try:
            rest = survivor.generate_adopted(out.manifest, out.k, out.v,
                                             13 - len(out.tokens))
            assert out.tokens + [int(x) for x in rest] == ref
        finally:
            survivor.stop()

    def test_exported_pages_equal_jax_and_adopt(self, lm):
        """A prefilled stream's pages equal JAX's export of the same
        prompt (within the f32 tolerance); adopted into a second
        session they decode JAX's tokens; a wrong geometry is refused
        with ``IncompatiblePages``."""
        from theanompi_tpu_torch.decode import IncompatiblePages, page_manifest

        sess = lm.session(page_size=4, pages_per_seq=4, max_seqs=2,
                          prefill_buckets=(8, 16))
        (prompt,) = prompts(36, 11)
        seq, logits = sess.admit(prompt)
        k, v = sess.export_pages(seq)
        jsess = lm.jax_session(4, 4, (8, 16))
        jseq, _ = jsess.admit(prompt)
        jk, jv = jsess.export_pages(jseq)
        jsess.release(jseq)
        assert_close(k.numpy(), jk)
        assert_close(v.numpy(), jv)
        first = int(np.argmax(logits))
        manifest = page_manifest(sess.cfg, prompt, seq.length, first)
        other = lm.session(page_size=4, pages_per_seq=4, max_seqs=2,
                           prefill_buckets=(8, 16))
        with pytest.raises(IncompatiblePages, match="page_size"):
            other.adopt_pages(dict(manifest, page_size=8), k, v)
        aseq = other.adopt_pages(manifest, k, v)
        out = [first]
        for _ in range(7):
            lg = other.decode([aseq], np.asarray([out[-1]]))
            out.append(int(np.argmax(lg[0])))
        assert out == lm.jax_greedy(prompt, 8, pages_per_seq=4)
