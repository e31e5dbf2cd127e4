"""The port's mesh (parallel/mesh.py) against the JAX package's, on the
CPU.

* the layout: rank r holds the coordinate JAX's mesh gives device r
  (``np.asarray(devices).reshape(shape)``), and the members of every set
  of axes, in order, are the devices JAX's mesh lines up along those
  axes (the order of an index over a tuple of axes, ``P(('data',
  'expert'))``), for several meshes of the 8 virtual CPU devices;
* ``MeshSpec.degrees`` with JAX's values and error messages;
* ``shard_batch``: each rank's block equals the shard JAX places on its
  device, under ``P('data')``, ``P('data', 'seq')`` and
  ``P(('data', 'expert'))``;
* on four gloo ranks (one spawn): ``make_training_mesh`` makes a group
  for every set of axes that neither spans the world nor has one rank,
  an all-reduce over each sums exactly its members, a one-rank set gets
  ``LOCAL`` and the whole world the default group;
* ``tools/sharded_bsp_probe.py``'s LM knobs (``sp``, ``tp``, ``pp``,
  ``ep``) through the launcher on two gloo ranks at the tests' tiny LM:
  every run ends, and its ranks' checkpoint digests agree.

The file is also the rank program: ``python test_torch_mesh.py RANK WORLD
PORT DIR``.
"""

import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_lm_ranks import init_ranks, load_ranks, save_rank  # noqa: E402

from theanompi_tpu_torch.parallel import mesh as M  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = [dict(data=8), dict(data=2, seq=4), dict(data=4, model=2),
         dict(data=2, model=2, seq=2), dict(data=2, pipe=2, expert=2),
         dict(data=1, model=2, pipe=2, seq=2)]


def _jax_mesh(spec):
    import jax

    from theanompi_tpu.parallel.mesh import MeshSpec, make_training_mesh

    return make_training_mesh(MeshSpec(**spec), jax.devices()[:8])


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_layout_matches_jax_device_array(spec):
    jm = _jax_mesh(spec)
    degrees = M.MeshSpec(**spec).degrees(8)
    assert tuple(jm.axis_names) == M.ALL_AXES
    assert dict(jm.shape) == degrees
    for idx in np.ndindex(jm.devices.shape):
        rank = jm.devices[idx].id
        assert M.mesh_coords(degrees, rank) == dict(zip(M.ALL_AXES, idx))


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_axis_members_match_jax_lines(spec):
    """For every set of axes: the devices sharing this device's other
    coordinates, row-major over the set (JAX's index order)."""
    jm = _jax_mesh(spec)
    degrees = M.MeshSpec(**spec).degrees(8)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for k in range(1, 6):
        for axes in itertools.combinations(M.ALL_AXES, k):
            keep = [i for i, a in enumerate(M.ALL_AXES) if a in axes]
            for idx in np.ndindex(ids.shape):
                sl = tuple(slice(None) if i in keep else c
                           for i, c in enumerate(idx))
                want = tuple(int(x) for x in ids[sl].reshape(-1))
                assert M.axis_members(degrees, int(ids[idx]), axes) == want
                mesh = M.Mesh(degrees, int(ids[idx]))
                index, size = mesh.place(axes)
                assert size == len(want) and want[index] == ids[idx]


@pytest.mark.parametrize("n,spec", [
    (8, dict(data=-1, model=2)), (8, dict(data=3, model=3)),
    (6, dict(data=-1, model=4)), (8, dict(data=2, seq=2, expert=2)),
    (4, dict(data=2, seq=4))])
def test_degrees_match_jax(n, spec):
    from theanompi_tpu.parallel.mesh import MeshSpec as JaxSpec

    def run(cls):
        try:
            return cls(**spec).degrees(n)
        except ValueError as e:
            return str(e)

    assert run(M.MeshSpec) == run(JaxSpec)


@pytest.mark.parametrize("spec,partition", [
    (dict(data=8), ("data",)), (dict(data=2, seq=4), ("data", "seq")),
    (dict(data=2, expert=4), (("data", "expert"),)),
    (dict(data=2, model=2, seq=2), ("data", "seq"))], ids=str)
def test_shard_batch_matches_jax_placement(spec, partition):
    from jax.sharding import PartitionSpec as P

    from theanompi_tpu.parallel.mesh import shard_batch as jax_shard

    jm = _jax_mesh(spec)
    degrees = M.MeshSpec(**spec).degrees(8)
    x = np.arange(16 * 8, dtype=np.int32).reshape(16, 8)
    placed = jax_shard(x, jm, P(*partition))
    for shard in placed.addressable_shards:
        mine = M.shard_batch((x, torch.from_numpy(x)),
                             M.Mesh(degrees, shard.device.id), partition)
        np.testing.assert_array_equal(mine[0], np.asarray(shard.data))
        np.testing.assert_array_equal(mine[1].numpy(),
                                      np.asarray(shard.data))


def test_local_batch_and_log2_as_jax():
    mesh = M.Mesh(M.MeshSpec(data=8).degrees(8), 0)
    assert M.data_axis_size(mesh) == 8 and M.local_batch(256, mesh) == 32
    with pytest.raises(ValueError, match="global batch 100 not divisible "
                                         "by data=8"):
        M.local_batch(100, mesh)
    assert M.log2_int(64) == 6
    with pytest.raises(ValueError, match="6 is not a power of two"):
        M.log2_int(6)
    with pytest.raises(ValueError, match="unknown mesh axis 'tensor'"):
        mesh.axis("tensor")


def test_one_process_mesh_has_only_local_groups():
    mesh = M.make_training_mesh(M.MeshSpec())
    assert mesh.shape == dict.fromkeys(M.ALL_AXES, 1)
    for axes in ("data", ("data", "seq"), M.ALL_AXES):
        g = mesh.axis(axes)
        assert g.trivial and g.group is M.LOCAL and g.members == (0,)
    assert M.data_mesh().shape["data"] == 1


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    init_ranks(rank, world, port)
    try:
        mesh = M.make_training_mesh(M.MeshSpec(data=2, seq=2))
        out = {}
        for k in range(1, 6):
            for axes in itertools.combinations(M.ALL_AXES, k):
                g = mesh.axis(axes)
                kind = ("local" if g.group is M.LOCAL else
                        "world" if g.group is None else "sub")
                total = None
                if not g.trivial:
                    t = torch.tensor([float(rank)])
                    dist.all_reduce(t, group=g.group)
                    total = float(t)
                out[axes] = (g.members, g.index, kind, total)
        out["data_mesh"] = M.data_mesh().shape
        save_rank(workdir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_exchange import spawn_ranks

    tmp = tmp_path_factory.mktemp("mesh")
    spawn_ranks(os.path.abspath(__file__), tmp, world=4, timeout=120)
    return load_ranks(tmp, 4)


def test_groups_reduce_over_exactly_their_members(ranks):
    degrees = M.MeshSpec(data=2, seq=2).degrees(4)
    for rank, out in enumerate(ranks):
        assert out["data_mesh"]["data"] == 4
        for k in range(1, 6):
            for axes in itertools.combinations(M.ALL_AXES, k):
                members, index, kind, total = out[axes]
                assert members == M.axis_members(degrees, rank, axes)
                assert members[index] == rank
                big = {"data", "seq"} & set(axes)
                want = ("local" if not big else
                        "world" if big == {"data", "seq"} else "sub")
                assert kind == want, axes
                if kind != "local":
                    assert total == sum(members)


def test_probe_lm_knobs_on_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    out = tmp_path / "summary.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "sharded_bsp_probe.py"),
         "-D", "2", "--platform", "cpu", "--knob", "sp", "--knob", "tp",
         "--knob", "pp", "--knob", "ep", "--lm-module", "_torch_lm_ranks",
         "--work", str(tmp_path / "work"), "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(out.read_text())
    assert set(summary) == {"sp-D2", "tp-D2", "pp-D2", "ep-D2"}
    for run in summary.values():
        assert run["rc"] == 0 and run["ranks_agree"]
        assert len(run["state_bytes"]) == 2 and run["ms_per_step"][0] > 0


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
