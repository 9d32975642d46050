"""The port's LM train step on a (data, model) process mesh for every layer
kind other than dense GQA, in bf16, against the JAX package's sharded step
(``param_specs`` / ``batch_specs_tree`` mode ``train`` under ``jax.jit``
with ``in_shardings``, 8 host devices), and each rank's shards against the
reference's devices'. The archs, configs, weights and batch are
tests/test_torch_lm_mesh_kinds.py's (its ``OVERRIDES`` included).

The reference runs in two subprocesses, one a mesh shape, started with the
module fixture and read after the port's spawns (``axis_types=Auto``: JAX
0.9's default Explicit axes refuse its ``with_sharding_constraint``). Bars:
the loss within 1e-3 and each weight within 1e-2
(tests/test_distributed.py:168-172), the gaps printed.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch import lm_mesh
from repro_torch.models.transformer import param_shapes
from test_torch_lm_mesh_kinds import (
    ARCHS, OVERRIDES, SHAPES, SRC, TIMEOUT, case, cfgs, named,
)

torch.set_num_threads(1)

BF16_LOSS, BF16_PARAM = 1e-3, 1e-2

_SHARDED = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    import repro_torch.configs as tcfg
    from repro_torch import convert
    from repro_torch.models.transformer import FLOAT32_LEAVES, tree_slots
    from repro.configs import get_config
    from repro.data.tokens import synthetic_batch
    from repro.models import sharding as shd
    from repro.launch.mesh import batch_specs_tree, param_specs, to_shardings
    from repro.training.optimizer import AdamWConfig
    from repro.training.train import init_train_state, make_train_step

    d, shape = sys.argv[1], tuple(json.loads(sys.argv[2]))
    with open(d + 'overrides.json') as fh:
        overrides = json.load(fh)
    key = 'x'.join(map(str, shape))
    res = {}
    for arch, over in overrides.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        tc = dataclasses.replace(tcfg.get_config(arch).reduced(), **over)
        with np.load(d + arch + '.npz') as z:
            tree = convert.lm_tree_from_named(tc, {k: z[k] for k in z.files})
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(a, jnp.float32 if path[-1].key in
                                        FLOAT32_LEAVES else cfg.dtype), tree)
        opt = init_train_state(cfg, params)
        batch = synthetic_batch(cfg, 0, 32, 8)
        mesh = jax.make_mesh(shape, ('data', 'model'),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        ps = param_specs(params, mesh)
        with mesh, shd.rules(batch='data', model='model', mesh=mesh):
            fn = jax.jit(make_train_step(cfg, AdamWConfig(total_steps=10)),
                         in_shardings=to_shardings(
                             (ps, dict(mu=ps, nu=ps, step=P()),
                              batch_specs_tree(batch, mesh)), mesh))
            p2, _, m2 = fn(params, opt, batch)
        np.savez(d + arch + '-' + key + '.npz', **{
            k: np.asarray(v, np.float32) for k, v in
            convert.lm_named_from_tree(tc, jax.tree.map(np.asarray,
                                                        p2)).items()})
        shards = {}
        for name, (path, g) in tree_slots(tc).items():
            leaf, spec = params, ps
            for k in path:
                leaf, spec = leaf[k], spec[k]
            arr = jax.device_put(leaf, NamedSharding(mesh, spec))
            by_dev = {s.device.id: s.index for s in arr.addressable_shards}
            shards[name] = [
                [[sl.start or 0, leaf.shape[i] if sl.stop is None
                  else sl.stop] for i, sl in enumerate(by_dev[r])][
                    0 if g is None else 1:]
                for r in range(shape[0] * shape[1])]
        res[arch] = dict(loss=float(m2['loss']), shards=shards)
        print(arch, key, float(m2['loss']), flush=True)
    with open(d + key + '-meta.json', 'w') as fh:
        json.dump(res, fh)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """Starts the reference's sharded bf16 steps, one subprocess a mesh
    shape; returns ``get(shape) -> {arch: (its loss, the weights after the
    step {port name: float32}, each device's shard of each weight as
    [[start, stop] a dim], device r for rank r)}``, waiting for them."""
    d = tmp_path_factory.mktemp("jax-sharded")
    for arch in ARCHS:
        np.savez(d / f"{arch}.npz", **named(arch, "bf16"))
    with open(d / "overrides.json", "w") as fh:
        json.dump({a: OVERRIDES.get(a, {}) for a in ARCHS}, fh)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {shape: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_SHARDED), str(d) + "/",
         json.dumps(shape)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for shape in SHAPES}
    done = {}

    def get(shape):
        if shape not in done:
            out, _ = procs[shape].communicate(timeout=900)
            assert procs[shape].returncode == 0, out
            key = "x".join(map(str, shape))
            with open(d / f"{key}-meta.json") as fh:
                meta = json.load(fh)
            done[shape] = {}
            for arch, m in meta.items():
                with np.load(d / f"{arch}-{key}.npz") as z:
                    done[shape][arch] = (m["loss"], {k: z[k] for k in z.files},
                                         m["shards"])
        return done[shape]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def runs(jax_sharded):
    """mesh shape -> {arch: TrainResult of one bf16 step}, one spawn a
    shape (the reference's subprocesses already started)."""
    done = {}

    def get(shape):
        if shape not in done:
            run = lm_mesh.run_lm_mesh_cases(
                [case(a, "bf16", keep=("params",)) for a in ARCHS], shape,
                device="cpu", timeout=TIMEOUT)
            done[shape] = dict(zip(ARCHS, run.results))
        return done[shape]
    return get


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_the_jax_sharded_step(runs, jax_sharded, shape, arch):
    res = runs(shape)[arch]
    loss, params, _ = jax_sharded(shape)[arch]
    gap = abs(res.metrics[0]["loss"] - loss)
    gaps = {k: float(np.abs(_np(w) - params[k]).max())
            for k, w in res.params.items()}
    worst = max(gaps, key=gaps.get)
    print(f"{shape} {arch} bf16: loss {res.metrics[0]['loss']} (jax sharded "
          f"{loss}, gap {gap:.3g}, bar {BF16_LOSS:g}); worst weight {worst} "
          f"{gaps[worst]:.3g} (bar {BF16_PARAM:g})")
    assert set(res.params) == set(params)
    assert gap < BF16_LOSS
    assert gaps[worst] < BF16_PARAM


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_each_rank_holds_the_reference_shard(runs, jax_sharded, shape, arch):
    """Each rank's weights have the shape of device r's shard under the
    reference's ``param_specs`` on an 8-device host mesh, and the launcher
    handed it that very piece (``shard_index``, the same slices): the
    expert banks, ``in_proj``, ``conv_*``, ``w_ukv``, the encoder's
    leaves, and the tables left whole over 'model'."""
    res = runs(shape)[arch]
    _, _, shards = jax_sharded(shape)[arch]
    _, tc = cfgs(arch, "bf16")
    mesh = lm_mesh.abstract_mesh(shape)
    specs = lm_mesh.param_specs(tc, mesh)
    full = param_shapes(tc)
    assert set(shards) == set(full)
    for r, rank in enumerate(res.ranks):
        for name, want in shards.items():
            assert rank["shards"][name] == [b - a for a, b in want[r]], \
                (r, name)
            idx = lm_mesh.shard_index(specs[name], full[name], mesh, r)
            assert [[s.start, s.stop] for s in idx] == want[r], (r, name)
