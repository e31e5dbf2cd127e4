"""Shared rank-side and JAX-side helpers of the LM family's multi-rank
pins (tests/test_torch_{sequence,tensor_parallel,pipeline,expert,
mesh}.py and the ZeRO-over-seq case of test_torch_zero.py).

A pin's test process draws the weights from the JAX model's own init,
carries them to the port's names (models/bridge.py) and writes them to
``weights.pt`` in the spawn's directory; each gloo rank (the test file
run as ``python FILE RANK WORLD PORT DIR``) builds the port model on its
mesh, loads its shards of those weights, trains a few steps on the same
synthetic stream and writes what it saw to ``out<rank>.pt``.  The JAX
side runs the same model, weights and stream on virtual CPU devices.
Nothing here imports JAX at module level: the ranks never load it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

#: the pins' tiny LM
DIMS = dict(vocab=32, n_layers=2, d_model=32, n_heads=4, seq_len=16)
#: its data: 32 training sequences, 16 for validation, one seed
DATA = dict(vocab=32, seq_len=16, n_train=32, n_val=16, seed=5)


def init_ranks(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def port_config(cls, **cfg):
    base = dict(batch_size=4, n_epochs=1, learning_rate=0.05,
                momentum=0.9, weight_decay=0.0, print_freq=0, seed=7)
    base.update(cfg)
    return dataclasses.replace(cls.default_config(), **base)


def train_port(cls, spec: dict, whole: dict, steps: int, dims=None,
               sync_type: str = "avg", **cfg):
    """On every rank: the port model ``cls`` on the mesh of ``spec``
    (MeshSpec kwargs) from the whole port state dict ``whole``, ``steps``
    training steps; returns (the losses, the whole parameters after (f32
    numpy by name) and the validation metrics; the model)."""
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.parallel.mesh import MeshSpec, make_training_mesh
    from theanompi_tpu_torch.utils.recorder import Recorder

    mesh = make_training_mesh(MeshSpec(**spec))
    dims = dict(DIMS, **(dims or {}))
    model = cls(config=port_config(cls, **cfg), device="cpu", mesh=mesh,
                data=SeqLM_data(**DATA), **dims)
    if hasattr(model, "load_whole_state_dict"):
        model.load_whole_state_dict(whole)
    else:
        model.module.load_state_dict(whole)
    model.compile_iter_fns(sync_type)
    rec = Recorder(rank=model.rank, size=model.n_workers, print_freq=0)
    model.begin_epoch(0)
    done = 0
    while done < steps:
        done += model.train_iter(done, rec)
    model._flush_metrics(rec)
    val = model.val_epoch(rec)
    model.cleanup()
    after = (model.whole_state_dict() if hasattr(model, "whole_state_dict")
             else dict(model.module.named_parameters()))
    return {"losses": list(rec.train_losses), "val": val,
            "params": {k: v.detach().float().numpy().copy()
                       for k, v in after.items()}}, model


def save_rank(workdir: str, rank: int, out: dict) -> None:
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


def load_ranks(workdir, world: int) -> list:
    return [torch.load(os.path.join(workdir, f"out{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- the JAX side (test process only) ------------------------------------------


def jax_model(cls, spec: dict, n_devices: int, dims=None, **cfg):
    """The JAX model ``cls`` on a mesh of ``spec`` over the first
    ``n_devices`` virtual CPU devices, the pins' config and data."""
    import jax

    from theanompi_tpu.data.lm import SeqLM_data as JaxSeqLM
    from theanompi_tpu.models.base import ModelConfig
    from theanompi_tpu.parallel.mesh import MeshSpec, make_training_mesh

    base = dict(batch_size=4, n_epochs=1, learning_rate=0.05, momentum=0.9,
                weight_decay=0.0, print_freq=0, seed=7,
                lr_schedule="constant")
    base.update(cfg)
    mesh = make_training_mesh(MeshSpec(**spec), jax.devices()[:n_devices])
    return cls(config=ModelConfig(**base), mesh=mesh, verbose=False,
               data=JaxSeqLM(**DATA), **dict(DIMS, **(dims or {})))


def train_jax(jm, steps: int, sync_type: str = "avg") -> dict:
    """``steps`` training steps of the JAX model; its losses and params
    (numpy)."""
    import jax

    from theanompi_tpu.utils.recorder import Recorder

    jm.compile_iter_fns(sync_type)
    rec = Recorder(rank=0, size=1, print_freq=0)
    jm.begin_epoch(0)
    done = 0
    while done < steps:
        done += jm.train_iter(done, rec)
    jm._flush_metrics(rec)
    jm.cleanup()
    return {"losses": list(np.asarray(rec.train_losses)),
            "params": jax.tree.map(np.asarray, jax.device_get(jm.params))}


def jax_tree(jm) -> dict:
    """The JAX model's initial parameters as numpy."""
    import jax

    return jax.tree.map(np.asarray, jax.device_get(jm.params))


def assert_params_close(got: dict, want: dict, rtol=2e-5, floor=1e-6,
                        msg="") -> None:
    """Every parameter by name: ``rtol`` with an absolute floor of
    ``floor * max|want|`` over the whole tree."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
            rtol=rtol, atol=floor * top, err_msg=f"{msg} {k}")


# -- tiny LM classes for the launcher (``-m _torch_lm_ranks -c <name>``) -------


#: each variant's own argument at the pins' size
_TINY_EXTRA = {"TransformerLM_PP": dict(n_microbatches=2),
               "TransformerLM_MoE": dict(n_experts=4)}


def _tiny(base):
    """``base`` at the pins' dims and data, one epoch of batch 4: the
    launcher builds a model from its class alone."""
    from theanompi_tpu_torch.data.lm import SeqLM_data

    class Tiny(base):
        @classmethod
        def default_config(cls):
            return port_config(base, learning_rate=0.02)

        def __init__(self, config=None, device="cuda", mesh=None):
            super().__init__(config, device, data=SeqLM_data(**DATA),
                             mesh=mesh, **DIMS,
                             **_TINY_EXTRA.get(base.__name__, {}))

    Tiny.__name__ = Tiny.__qualname__ = base.__name__
    return Tiny


def __getattr__(name):
    """``TransformerLM``, ``TransformerLM_TP``, ``TransformerLM_PP`` and
    ``TransformerLM_MoE`` at the pins' size."""
    from theanompi_tpu_torch.models import transformer

    if name.startswith("TransformerLM"):
        return _tiny(getattr(transformer, name))
    raise AttributeError(name)
