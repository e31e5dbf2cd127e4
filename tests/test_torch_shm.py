"""The port's shared-memory lane (``theanompi_tpu_torch/parallel/shm.py``
with its wire) against the JAX package's (``tests/test_shm.py``).

The arena's lease, recycle and refusal matrix; the codec's out-of-band
leaves, byte-identical and acked; the negotiation matrix; and the lane
ACROSS the packages: a JAX sender's segments mapped by a port receiver
(and the reverse), the acks of each applied by the other's arena, since
both keep the segment prefix ``tmshm``.

Every test releases its segments before it returns (the autouse fixture
below releases the port's arena; the suite's guard releases JAX's), and
none holds one across a wait: the suite's host-wide segment guard would
otherwise judge them in a test running beside these.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from theanompi_tpu.parallel import shm as jshm
from theanompi_tpu.parallel import wire as jwire
from theanompi_tpu_torch.parallel import shm, wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def shm_env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "1")
    monkeypatch.setenv("THEANOMPI_TPU_SHM_MIN_BYTES", "1024")
    yield
    shm.release_all()
    jshm.release_all()


def big_tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 16)).astype(np.float32),
            "f64": rng.standard_normal((300,)),
            "px": rng.integers(0, 255, (40, 40), dtype=np.uint8),
            "step": np.arange(8, dtype=np.int32),
            "empty": np.zeros((0, 3), np.float32)}


def assert_same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def lane_pair(client_mod=shm, server_mod=shm, client_wire=wire,
              server_wire=wire):
    """Two ends of a negotiated lane (offer -> grant -> channels), each
    end from either package."""
    offer = client_mod.client_offer()
    assert offer is not None
    server_ch, grant = server_mod.server_grant(offer)
    assert server_ch is not None
    client_ch = client_mod.client_channel(offer, {"shm": grant})
    assert client_ch is not None
    return (client_wire.WireOptions(allow_pickle=False, shm=client_ch),
            server_wire.WireOptions(allow_pickle=False, shm=server_ch))


def test_prefix_is_the_jax_prefix():
    assert shm.SEG_PREFIX == jshm.SEG_PREFIX == "tmshm"
    assert shm.HEADER_MAGIC == jshm.HEADER_MAGIC


# -- the arena --------------------------------------------------------------


def test_alloc_put_map_decref_recycles():
    a = shm.arena()
    payload = os.urandom(5000)
    lease = a.alloc(len(payload))
    off = lease.put(payload)
    assert off is not None and off % 64 == 0
    m = shm.map_payload(lease.name, lease.generation)
    try:
        assert bytes(m[off:off + len(payload)]) == payload
    finally:
        m.close()
    a.decref(lease.name, lease.generation)
    assert a.outstanding() == 0
    assert lease.name in shm.segment_names()  # parked for reuse
    lease2 = a.alloc(len(payload))
    assert lease2.name == lease.name
    assert lease2.generation > lease.generation
    with pytest.raises(shm.StaleGeneration):
        shm.map_payload(lease.name, lease.generation)
    a.decref(lease2.name, lease2.generation)
    a.release_all()
    assert lease.name not in shm.segment_names()


def test_decref_and_map_refusal_matrix():
    a = shm.arena()
    with pytest.raises(shm.ForeignSegment):
        a.decref(f"{shm.SEG_PREFIX}_999999_dead_1", 1)
    lease = a.alloc(100)
    with pytest.raises(shm.StaleGeneration):
        a.decref(lease.name, lease.generation + 7)
    a.decref(lease.name, lease.generation)
    with pytest.raises(shm.DoubleDecref):
        a.decref(lease.name, lease.generation)
    with pytest.raises(shm.ForeignSegment):
        shm.map_payload("not_a_lane_segment", 1)
    with pytest.raises(shm.LeaseExpired):
        shm.map_payload(f"{shm.SEG_PREFIX}_1_nothere_1", 1)


def test_lease_expiry_swept(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SHM_LEASE_S", "0.05")
    a = shm.arena()
    lease = a.alloc(100)
    time.sleep(0.1)
    assert a.sweep() >= 1
    assert a.outstanding() == 0
    assert lease.name not in shm.segment_names()
    with pytest.raises(shm.LeaseExpired):
        shm.map_payload(lease.name, lease.generation)


def test_alloc_cap_degrades_not_raises(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SHM_MAX_BYTES", "4096")
    assert shm.arena().alloc(1 << 20) is None


def test_orphans_of_a_dead_owner_are_swept():
    code = ("import sys, time\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from theanompi_tpu_torch.parallel import shm\n"
            "lease = shm.arena().alloc(4096)\n"
            "print(lease.name, flush=True)\n"
            "time.sleep(60)\n")
    p = subprocess.Popen([sys.executable, "-c", code],
                         stdout=subprocess.PIPE, text=True)
    try:
        name = p.stdout.readline().strip()
        assert name in shm.segment_names()
        p.kill()
        p.wait(timeout=10)
        deadline = time.monotonic() + 10
        while name in shm.segment_names():
            shm.sweep_orphans()
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        p.kill()
        p.wait(timeout=10)


# -- the codec --------------------------------------------------------------


def test_roundtrip_byte_identical_and_acked():
    send, recv = lane_pair()
    tree = big_tree()
    head, bufs, stats = wire.encode_frame(tree, send)
    assert stats._shm_oob == sum(tree[k].nbytes for k in ("w", "f64", "px"))
    assert len(bufs) == 2
    back = wire.decode_frame(head, [bytes(b) for b in bufs], recv)
    assert_same(back, tree)
    assert not back["w"].flags.writeable
    assert shm.arena().outstanding() == 1
    del back  # the views' death queues the ack
    h2, b2, _ = wire.encode_frame(("ok", None), recv)
    assert wire.decode_frame(h2, b2, send) == ("ok", None)
    assert shm.arena().outstanding() == 0
    send.shm.close()
    recv.shm.close()


def test_oob_leaves_skip_the_bf16_rewrite():
    offer = shm.client_offer()
    ch_s, grant = shm.server_grant(offer)
    ch_c = shm.client_channel(offer, {"shm": grant})
    send = wire.WireOptions(dtype="bf16", allow_pickle=False, shm=ch_c)
    recv = wire.WireOptions(dtype="bf16", allow_pickle=False, shm=ch_s)
    rng = np.random.default_rng(5)
    tree = {"big": rng.standard_normal(1000).astype(np.float32),
            "small": rng.standard_normal(17).astype(np.float32)}
    back = wire.decode_frame(*wire.encode_frame(tree, send)[:2], recv)
    assert back["big"].tobytes() == tree["big"].tobytes()
    assert back["small"].tobytes() != tree["small"].tobytes()
    np.testing.assert_allclose(back["small"], tree["small"], rtol=2 ** -8)
    del back
    ch_c.close()
    ch_s.close()


def test_refusals_are_typed():
    send, recv = lane_pair()
    head, bufs, _ = wire.encode_frame(big_tree(), send)
    with pytest.raises(wire.ShmRefusal, match="no shm lane"):
        wire.decode_frame(head, bufs, wire.WireOptions(allow_pickle=False))
    shm.release_all()  # the owner swept before the receiver mapped
    with pytest.raises(wire.ShmRefusal, match="LeaseExpired"):
        wire.decode_frame(head, bufs, recv)
    send.shm.close()
    recv.shm.close()


def test_channel_close_releases_unacked_leases():
    send, recv = lane_pair()
    wire.encode_frame(big_tree(), send)  # never delivered
    assert shm.arena().outstanding() == 1
    send.shm.close()
    assert shm.arena().outstanding() == 0
    recv.shm.close()


def test_negotiation_matrix(monkeypatch):
    offer = shm.client_offer()
    opts, reply, _ = wire.accept_hello(
        wire.hello_payload(wire.WireOptions(), shm_offer=offer),
        allow_shm=True)
    assert opts.shm is not None and reply["shm"]["granted"] is True
    ch = shm.client_channel(offer, reply)
    assert ch is not None and ch.role == "client"
    opts.shm.close()
    ch.close()
    remote = dict(shm.client_offer(), boot_id="some-other-host")
    opts, reply, _ = wire.accept_hello(
        wire.hello_payload(wire.WireOptions(), shm_offer=remote),
        allow_shm=True)
    assert opts.shm is None and "shm" not in reply
    _, grant = shm.server_grant(dict(offer, nonce="replayed"))
    assert shm.client_channel(offer, {"shm": grant}) is None
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    assert shm.client_offer() is None


# -- across the packages ----------------------------------------------------


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_lane_across_packages(sender):
    """A lane whose client end is one package and server end the other:
    out-of-band frames decode byte-identical in both directions, and the
    receiver's piggybacked acks release the sender's arena."""
    if sender == "jax":
        send, recv = lane_pair(jshm, shm, jwire, wire)
        s_wire, r_wire, s_arena = jwire, wire, jshm.arena()
    else:
        send, recv = lane_pair(shm, jshm, wire, jwire)
        s_wire, r_wire, s_arena = wire, jwire, shm.arena()
    tree = big_tree(1)
    head, bufs, stats = s_wire.encode_frame(tree, send)
    assert stats._shm_oob > 0
    assert s_arena.outstanding() == 1
    back = r_wire.decode_frame(head, [bytes(b) for b in bufs], recv)
    assert_same(back, tree)
    del back
    h2, b2, _ = r_wire.encode_frame(("ok", None), recv)
    assert s_wire.decode_frame(h2, b2, send) == ("ok", None)
    assert s_arena.outstanding() == 0
    send.shm.close()
    recv.shm.close()


def test_jax_segment_maps_in_the_port_and_back():
    lease = jshm.arena().alloc(256)
    off = lease.put(b"x" * 200)
    m = shm.map_payload(lease.name, lease.generation)
    try:
        assert bytes(m[off:off + 200]) == b"x" * 200
    finally:
        m.close()
    jshm.arena().decref(lease.name, lease.generation)
    lease = shm.arena().alloc(256)
    off = lease.put(b"y" * 100)
    m = jshm.map_payload(lease.name, lease.generation)
    try:
        assert bytes(m[off:off + 100]) == b"y" * 100
    finally:
        m.close()
    shm.arena().decref(lease.name, lease.generation)


def test_a_full_dev_shm_ships_in_band(monkeypatch):
    """A frame larger than /dev/shm's free space takes no segment (tmpfs
    would fault on the copy): the lane degrades to in-band bytes."""
    monkeypatch.setattr(shm, "free_bytes", lambda: 1 << 20)
    assert shm.arena().alloc(4 << 20) is None
    send, recv = lane_pair()
    big = {"w": np.ones(2 << 20, np.uint8)}
    head, bufs, stats = wire.encode_frame(big, send)
    assert getattr(stats, "_shm_oob", 0) == 0 and len(bufs) == 1
    assert_same(wire.decode_frame(head, bufs, recv), big)
    send.shm.close()
    recv.shm.close()
