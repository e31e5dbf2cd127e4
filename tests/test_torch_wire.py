"""The port's framed wire (``theanompi_tpu_torch/parallel/wire.py``)
against the JAX package's.

* **Frames across the packages.** The same message encodes to the same
  bytes (header, skeleton and every buffer) in both packages, for f32,
  bf16 and zlib frames, a ``RawArrays`` frame and a bf16 leaf (an
  ``ml_dtypes`` array in JAX, a ``torch.bfloat16`` tensor in the port);
  each package decodes the other's frames.
* **bf16 without ml_dtypes.** The port rounds f32 to bf16 with numpy bit
  arithmetic, bit-identical to ``ml_dtypes`` over a seeded set that
  holds ties, subnormals, +-inf and NaN payloads (``ml_dtypes`` runs only
  here, in the test).
* **Namedtuple refusal.** A frame naming ``optax``, ``jax``, ``flax`` or
  ``theanompi_tpu`` is refused without importing anything (checked in a
  fresh interpreter).
* The decoder's hardening, negotiation and ``RawArrays`` as in JAX's
  ``tests/test_wire.py``.
"""

from __future__ import annotations

import collections
import json
import os
import struct
import subprocess
import sys
import zlib
from multiprocessing import Pipe

import ml_dtypes
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import wire as jwire
from theanompi_tpu_torch.parallel import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Point = collections.namedtuple("Point", ["x", "y"])
JBF16 = np.dtype(ml_dtypes.bfloat16)


def mixed_tree():
    rng = np.random.default_rng(5)
    return {
        "f32": (rng.standard_normal((33, 40)) * 3).astype(np.float32),
        "f64": np.linspace(0, 1, 7),
        "i32": np.arange(-5, 5, dtype=np.int32),
        "u8": np.arange(256, dtype=np.uint8).reshape(16, 16),
        "zeros": np.zeros(4096, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        "scalar0d": np.float32(3.25),
        "nested": [1, 2.5, "three", None, True, b"raw",
                   (4, {"deep": np.full((5,), 7, np.int64)})],
        "nt": Point(np.float32(1.5), [np.ones(700, np.float32)]),
    }


def frame_bytes(mod, msg, opts):
    head, bufs, _ = mod.encode_frame(msg, opts)
    return bytes(head), [bytes(b) for b in bufs]


def assert_equal_leaves(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_equal_leaves(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal_leaves(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


# -- frames across the packages ---------------------------------------------


@pytest.mark.parametrize("compression,dtype", [
    ("none", "f32"), ("none", "bf16"), ("zlib", "f32"), ("zlib", "bf16")])
def test_frames_are_byte_identical_across_packages(compression, dtype):
    msg = ("ok", mixed_tree())
    got = frame_bytes(wire, msg, wire.WireOptions(compression, dtype))
    want = frame_bytes(jwire, msg, jwire.WireOptions(compression, dtype))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[1]) == 8


@pytest.mark.parametrize("compression,dtype", [
    ("none", "f32"), ("zlib", "bf16")])
def test_each_package_decodes_the_others_frames(compression, dtype):
    msg = mixed_tree()
    head, bufs = frame_bytes(jwire, msg, jwire.WireOptions(compression,
                                                           dtype))
    from_jax = wire.decode_frame(head, bufs, wire.WireOptions())
    head, bufs = frame_bytes(wire, msg, wire.WireOptions(compression, dtype))
    from_port = jwire.decode_frame(head, bufs, jwire.WireOptions())
    assert_equal_leaves(from_jax, from_port)
    if dtype == "f32":
        assert_equal_leaves(from_jax, msg)
    assert isinstance(from_jax["nt"], Point)


def test_raw_arrays_frame_is_byte_identical():
    x = np.arange(3 * 8 * 8, dtype=np.uint8).reshape(3, 8, 8)
    y = np.arange(3, dtype=np.int32)
    f32 = np.linspace(-1, 1, 600, dtype=np.float32)
    opts = dict(compression="zlib", dtype="bf16")
    got = frame_bytes(wire, ("ok", wire.RawArrays(x, y, f32)),
                      wire.WireOptions(**opts))
    want = frame_bytes(jwire, ("ok", jwire.RawArrays(x, y, f32)),
                       jwire.WireOptions(**opts))
    assert got == want
    status, out = wire.decode_frame(got[0], got[1], wire.WireOptions())
    assert status == "ok" and type(out) is tuple
    for a, b in zip(out, (x, y, f32)):  # raw: no bf16, no zlib
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_bf16_leaf_travels_as_a_torch_tensor():
    """A leaf whose own dtype is bf16: an ml_dtypes array in JAX, a CPU
    ``torch.bfloat16`` tensor in the port; the frames are identical and
    it decodes to a bf16 tensor, never another dtype (also on the bf16
    wire, which re-dtypes only f32)."""
    vals = np.random.default_rng(3).standard_normal(600).astype(np.float32)
    jleaf = vals.astype(JBF16)
    pleaf = torch.from_numpy(vals).to(torch.bfloat16)
    for dtype in ("f32", "bf16"):
        got = frame_bytes(wire, {"b": pleaf}, wire.WireOptions(dtype=dtype))
        want = frame_bytes(jwire, {"b": jleaf},
                           jwire.WireOptions(dtype=dtype))
        assert got == want
        out = wire.decode_frame(*got, wire.WireOptions())["b"]
        assert out.dtype == torch.bfloat16 and out.shape == (600,)
        assert torch.equal(out.view(torch.int16), pleaf.view(torch.int16))
        back = jwire.decode_frame(*got, jwire.WireOptions())["b"]
        assert back.dtype == JBF16
        assert back.tobytes() == jleaf.tobytes()
    # JAX's bf16 leaf decodes to a port bf16 tensor
    out = wire.decode_frame(*frame_bytes(jwire, [jleaf],
                                         jwire.WireOptions()))[0]
    assert out.dtype == torch.bfloat16


# -- bf16 rounding ----------------------------------------------------------


def bf16_probe_values() -> np.ndarray:
    rng = np.random.default_rng(2024)
    normal = (rng.standard_normal(20000) * 10.0 ** rng.integers(
        -30, 30, 20000)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    # exact ties (low half 0x8000) on both even and odd bf16 mantissas
    ties = ((rng.integers(0, 2 ** 16, 4000, dtype=np.uint32) << 16)
            | np.uint32(0x8000))
    sub = rng.integers(1, 0x00800000, 4000, dtype=np.uint32)  # subnormals
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                        0x7F800001, 0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF,
                        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x00000000,
                        0x80000000, 0x00000001, 0x80000001, 0x00008000,
                        0x00018000, 0x3F808000, 0x3F818000],
                       np.uint32)
    return np.concatenate([normal.view(np.uint32), bits, ties, sub,
                           sub | np.uint32(0x80000000), special]
                          ).view(np.float32)


def test_bf16_rounding_is_bit_identical_to_ml_dtypes():
    vals = bf16_probe_values()
    got = wire.f32_to_bf16_bits(vals)
    with np.errstate(invalid="ignore"):
        want = vals.astype(JBF16).view(np.uint16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    # and widening back is ml_dtypes' widening
    np.testing.assert_array_equal(
        wire.bf16_bits_to_f32(got).view(np.uint32),
        want.view(JBF16).astype(np.float32).view(np.uint32))


def test_bf16_wire_restores_f32_like_jax():
    vals = bf16_probe_values()
    finite = vals[np.isfinite(vals)]
    opts = ("none", "bf16")
    got = frame_bytes(wire, [finite], wire.WireOptions(*opts))
    out = wire.decode_frame(*got, wire.WireOptions())[0]
    ref = jwire.decode_frame(*got, jwire.WireOptions())[0]
    assert out.dtype == np.float32
    assert out.tobytes() == ref.tobytes()


def test_bf16_options_need_no_ml_dtypes():
    """``WireOptions(dtype='bf16')`` and the bf16 frame path work in a
    fresh interpreter where ``ml_dtypes`` cannot be imported."""
    code = (
        "import sys, numpy as np\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from theanompi_tpu_torch.parallel import wire\n"
        "o = wire.WireOptions(dtype='bf16')\n"
        "h, b, s = wire.encode_frame([np.ones(8, np.float32)], o)\n"
        "out = wire.decode_frame(h, [bytes(x) for x in b], o)\n"
        "assert out[0].dtype == np.float32 and (out[0] == 1).all()\n"
        "print('bf16 ok')\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=60)
    assert p.returncode == 0, p.stderr
    assert "bf16 ok" in p.stdout


# -- namedtuples ------------------------------------------------------------


def nt_frame(mod: str, qual: str) -> tuple[bytes, list]:
    skel = json.dumps({"t": "nt", "mod": mod, "qual": qual,
                       "v": [{"t": "i", "v": 1}]},
                      separators=(",", ":")).encode()
    return struct.pack(">4sBBII", wire.MAGIC, wire.WIRE_VERSION, 0, 0,
                       len(skel)) + skel, []


def test_namedtuples_of_jax_are_refused_without_importing():
    code = (
        "import json, struct, sys\n"
        "from theanompi_tpu_torch.parallel import wire\n"
        "names = [('optax', 'ScaleByAdamState'), ('optax._src.base', "
        "'EmptyState'), ('jax.tree_util', 'X'), ('flax.core', 'Y'), "
        "('theanompi_tpu.parallel.wire', 'WireStats'), "
        "('theanompi_tpu', 'Z')]\n"
        "for mod, qual in names:\n"
        "    skel = json.dumps({'t': 'nt', 'mod': mod, 'qual': qual, "
        "'v': []}).encode()\n"
        "    head = struct.pack('>4sBBII', wire.MAGIC, wire.WIRE_VERSION, "
        "0, 0, len(skel)) + skel\n"
        "    try:\n"
        "        wire.decode_frame(head, [])\n"
        "    except wire.WireDecodeError as e:\n"
        "        assert mod in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('accepted ' + mod)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('optax', 'jax', 'flax', 'theanompi_tpu', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print('refused', len(names))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=60)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "refused 6" in p.stdout


def test_namedtuple_of_another_module_resolves_as_in_jax():
    out = wire.decode_frame(*frame_bytes(
        wire, {"p": Point(np.float32(1.0), [np.zeros(2, np.float32)])},
        wire.WireOptions()))
    assert type(out["p"]) is Point
    head, bufs = nt_frame("os", "getcwd")  # a callable, not a namedtuple
    with pytest.raises(wire.WireDecodeError, match="not a namedtuple"):
        wire.decode_frame(head, bufs)


# -- hardening (JAX's tests/test_wire.py) -----------------------------------


def good_frame():
    return frame_bytes(wire, {"x": np.arange(64, dtype=np.float32)},
                       wire.WireOptions())


@pytest.mark.parametrize("mutate,match", [
    (lambda h: b"XXXX" + h[4:], "magic"),
    (lambda h: h[:4] + bytes([9]) + h[5:], "version"),
    (lambda h: h[:6], "header"),
    (lambda h: h[:-3], "truncated"),
    (lambda h: h[:-2] + b"}}", "skeleton"),
])
def test_malformed_headers_raise_typed_errors(mutate, match):
    head, bufs = good_frame()
    with pytest.raises(wire.WireDecodeError, match=match):
        wire.decode_frame(mutate(head), bufs)


def test_zlib_bomb_is_bounded():
    bomb = zlib.compress(b"\0" * (1 << 20), 9)
    skel = json.dumps({"t": "nd", "i": 0, "dtype": "uint8", "shape": [16],
                       "rawlen": 16, "comp": "zlib"}).encode()
    head = struct.pack(">4sBBII", wire.MAGIC, wire.WIRE_VERSION, 0, 1,
                       len(skel)) + skel
    with pytest.raises(wire.WireDecodeError, match="declared"):
        wire.decode_frame(head, [bomb])


def test_fuzz_mutations_raise_typed_errors_only():
    head, bufs = good_frame()
    rng = np.random.default_rng(11)
    for _ in range(200):
        h = bytearray(head)
        for i in rng.integers(0, len(h), 3):
            h[i] = int(rng.integers(0, 256))
        try:
            wire.decode_frame(bytes(h), bufs)
        except wire.WireDecodeError:
            pass


def test_truncated_stream_times_out_not_hangs():
    a, b = Pipe()
    try:
        head, bufs, _ = wire.encode_frame(
            {"x": np.zeros(16, np.float32), "y": np.ones(16, np.float32)},
            wire.WireOptions())
        a.send_bytes(head)
        a.send_bytes(bytes(bufs[0]))
        with pytest.raises(wire.WireDecodeError, match="truncated"):
            wire.recv_msg(b, buf_timeout_s=0.2)
    finally:
        a.close()
        b.close()


def test_connection_survives_drained_corrupt_frame():
    a, b = Pipe()
    try:
        skel = json.dumps({"t": "nd", "i": 0, "dtype": "float32",
                           "shape": "NOT-A-SHAPE", "rawlen": 8,
                           "comp": "none"}).encode()
        a.send_bytes(struct.pack(">4sBBII", wire.MAGIC, wire.WIRE_VERSION,
                                 0, 1, len(skel)) + skel)
        a.send_bytes(b"\0" * 8)
        with pytest.raises(wire.WireDecodeError) as ei:
            wire.recv_msg(b, buf_timeout_s=1.0)
        assert ei.value.frame_drained is True
        # a JAX sender's next frame decodes on the same connection
        jwire.send_msg(a, {"ok": np.arange(3, dtype=np.float32)},
                       jwire.WireOptions())
        out = wire.recv_msg(b, buf_timeout_s=1.0)
        assert out["ok"].tobytes() == np.arange(3, dtype=np.float32).tobytes()
    finally:
        a.close()
        b.close()


def test_pickle_escape_needs_allow_pickle():
    head, bufs = frame_bytes(wire, {"s": {1, 2}}, wire.WireOptions())
    with pytest.raises(wire.WireDecodeError, match="allow_pickle"):
        wire.decode_frame(head, bufs, wire.WireOptions(allow_pickle=False))
    assert wire.decode_frame(head, bufs)["s"] == {1, 2}


# -- negotiation ------------------------------------------------------------


def test_hello_is_the_jax_hello_and_degrades_like_it():
    opts = wire.WireOptions(compression="zlib", dtype="bf16")
    assert wire.hello_payload(opts, trace=False) == jwire.hello_payload(
        jwire.WireOptions(compression="zlib", dtype="bf16"), trace=False)
    got, reply, mux = wire.accept_hello(
        {"version": 2, "compression": "lz4", "dtype": "f8", "mux": True})
    assert (got.compression, got.dtype, got.allow_pickle, mux) == (
        "none", "f32", False, False)
    assert reply == {"version": 2, "compression": "none", "dtype": "f32"}
    with pytest.raises(wire.WireProtocolError):
        wire.accept_hello({"version": 1})
    with pytest.raises(ValueError):
        wire.WireOptions(dtype="f16")
