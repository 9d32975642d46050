"""The port's LM train step on a (data, model) process mesh
(``launch/lm_mesh.py::run_train_mesh``: gloo ranks on the CPU, one a
process) against the JAX package, at reduced minitron-4b as
tests/test_distributed.py:139 sets it up: ``synthetic_batch(cfg, 0, 32, 8)``,
``AdamWConfig(total_steps=10)``, and weights drawn with numpy from seed 0,
carried to both packages (``convert``).

One spawn a mesh shape runs every case of that shape (a module fixture),
and one subprocess with 8 host devices runs the reference's sharded step
(``jax.make_mesh(..., axis_types=Auto)``: JAX 0.9's default Explicit axes
refuse its ``with_sharding_constraint``) and reports each device's shards.

Bars, those of tests/test_torch_train.py. float32 against the JAX
single-device step: the loss within rtol 1e-6, each gradient leaf within
1e-5 of its largest |g|, grad_norm within rtol 1e-5, mu within the gradient
bar of its largest |mu| and nu twice it, each weight within 2 · lr. bf16
against the JAX sharded step: the loss within 1e-3 and each weight within
1e-2 (tests/test_distributed.py:168-172), the gaps printed. Compression:
as tests/test_torch_train.py::test_grad_compress_matches_the_reference.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.training.optimizer as ropt
import repro.training.train as rtrain
import repro_torch.configs as tcfg
import repro_torch.training.optimizer as topt
from repro.data.tokens import synthetic_batch as ref_batch
from repro_torch import convert
from repro_torch.data.tokens import synthetic_batch
from repro_torch.launch import lm_mesh
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import MeshFailed
from repro_torch.models.transformer import check_grid, param_shapes

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ARCH = "minitron-4b"
SHAPES = ((2, 4), (2, 2))
B, S = 8, 32
TOTAL_STEPS = 10
LOSS_RTOL, GRAD_BAR, GN_RTOL = 1e-6, 1e-5, 1e-5
BF16_LOSS, BF16_PARAM = 1e-3, 1e-2
TIMEOUT = 120.0


def _cfgs(dtype="f32", arch=ARCH, **kw):
    """(reference config, port config), reduced, float32 unless bf16."""
    out = []
    for reg, f32 in ((rcfg, jnp.float32), (tcfg, torch.float32)):
        cfg = reg.get_config(arch).reduced()
        if dtype == "f32":
            cfg = dataclasses.replace(cfg, dtype=f32)
        out.append(dataclasses.replace(cfg, **kw))
    return out


@functools.lru_cache(maxsize=None)
def _named(dtype="f32", arch=ARCH) -> dict:
    """Every weight, ``{port name: float32 array}``, from numpy seed 0:
    N(0, 0.02), norms included (their gradients are then not trivial);
    rounded to bf16 for ``dtype="bf16"``."""
    _, tc = _cfgs(dtype, arch)
    rng = np.random.default_rng(0)
    out = {}
    for k, shape in param_shapes(tc).items():
        a = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        if dtype == "bf16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out[k] = a
    return out


def _ref_params(dtype="f32", arch=ARCH):
    """The reference's param tree of the same weights (jnp, its dtype)."""
    rc, tc = _cfgs(dtype, arch)
    tree = convert.lm_tree_from_named(tc, _named(dtype, arch))
    return jax.tree.map(lambda a: jnp.asarray(a, rc.dtype), tree)


def _port_params(dtype="f32", arch=ARCH) -> dict:
    _, tc = _cfgs(dtype, arch)
    return {k: torch.tensor(a).to(tc.dtype) for k, a in
            _named(dtype, arch).items()}


def _batch():
    _, tc = _cfgs()
    return synthetic_batch(tc, 0, S, B, device="cpu")


def _opt_cfgs():
    kw = dict(total_steps=TOTAL_STEPS)
    return ropt.AdamWConfig(**kw), topt.AdamWConfig(**kw)


def _case(dtype="f32", keep=("params", "mu", "nu"), arch=ARCH, **kw):
    cfg_kw = {k: kw.pop(k) for k in ("remat", "grad_compress") if k in kw}
    _, tc = _cfgs(dtype, arch, **cfg_kw)
    return lm_mesh.TrainCase(tc, _port_params(dtype, arch), _batch(),
                             opt_cfg=_opt_cfgs()[1], keep=keep, **kw)


#: the cases of each spawn, by name
CASES = {
    "f32": dict(keep=("params", "mu", "nu", "grads"), repeats=2),
    "f32-remat": dict(keep=("params", "grads"), remat=True),
    "bf16": dict(dtype="bf16", keep=("params",)),
    "compress-mb2": dict(keep=("params", "mu", "nu", "err"), steps=2,
                         microbatches=2, grad_compress=True),
    # tied embeddings (one table gathered twice) and windowed layers
    "gemma3": dict(arch="gemma3-12b", keep=("params", "mu", "nu", "grads")),
}


@pytest.fixture(scope="module")
def runs():
    """mesh shape -> {case name: TrainResult}, one spawn a shape."""
    done = {}

    def get(shape):
        if shape not in done:
            # the reference's state after one step, as its trees
            _jax_single()
            params, opt = _jax_single.trees[(1, 1, False, ARCH)]
            resumed = _case(keep=("params", "mu", "nu"))
            resumed = dataclasses.replace(resumed, params=params, opt=opt)
            run = lm_mesh.run_train_mesh_cases(
                [_case(**kw) for kw in CASES.values()] + [resumed], shape,
                device="cpu", timeout=TIMEOUT)
            done[shape] = dict(zip(list(CASES) + ["resumed"], run.results))
        return done[shape]
    return get


_SHARDED = """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    import repro_torch.configs as tcfg
    from repro_torch import convert
    from repro_torch.models.transformer import tree_slots
    from repro.configs import get_config
    from repro.data.tokens import synthetic_batch
    from repro.models import sharding as shd
    from repro.launch.mesh import batch_specs_tree, param_specs, to_shardings
    from repro.training.optimizer import AdamWConfig
    from repro.training.train import init_train_state, make_train_step

    src, out = sys.argv[1], sys.argv[2]
    cfg = get_config('minitron-4b').reduced()
    tc = tcfg.get_config('minitron-4b').reduced()
    with np.load(src) as z:
        named = {k: z[k] for k in z.files}
    params = jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype),
                          convert.lm_tree_from_named(tc, named))
    opt = init_train_state(cfg, params)
    batch = synthetic_batch(cfg, 0, 32, 8)
    slots = tree_slots(tc)
    res = {}
    for shape in [(2, 4), (2, 2)]:
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
        key = 'x'.join(map(str, shape))
        np.savez(out + key + '.npz', **{
            k: np.asarray(v, np.float32) for k, v in
            convert.lm_named_from_tree(tc, jax.tree.map(np.asarray,
                                                        p2)).items()})
        shards = {}
        for name, (path, g) in slots.items():
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
        res[key] = dict(loss=float(m2['loss']), shards=shards)
    with open(out + 'meta.json', 'w') as fh:
        json.dump(res, fh)
    print('OK')
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The reference's sharded bf16 step from the same weights in a
    subprocess with 8 host devices: mesh shape -> (its loss, the weights
    after the step ``{port name: float32}``, each device's shard of each
    weight as ``[[start, stop] a dim]``, device r for rank r)."""
    d = tmp_path_factory.mktemp("jax-sharded")
    src = str(d / "params.npz")
    np.savez(src, **_named("bf16"))
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_SHARDED), src,
                        str(d) + "/"], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(d / "meta.json") as fh:
        meta = json.load(fh)
    out = {}
    for key, m in meta.items():
        shape = tuple(int(x) for x in key.split("x"))
        with np.load(d / f"{key}.npz") as z:
            out[shape] = (m["loss"], {k: z[k] for k in z.files}, m["shards"])
    return out


@functools.lru_cache(maxsize=None)
def _jax_single(steps=1, microbatches=1, compress=False, arch=ARCH):
    """The reference's single-device step from the same weights:
    ``(metrics a step, gradients of the first step, params', opt')``, the
    last two ``{port name: float32}``; ``_jax_single.trees[key]`` keeps
    them as the reference's trees of numpy arrays (``step`` included)."""
    rc, tc = _cfgs(arch=arch, grad_compress=compress)
    ocfg, _ = _opt_cfgs()
    params = _ref_params(arch=arch)
    opt = rtrain.init_train_state(rc, params)
    rbatch = ref_batch(rc, 0, S, B)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: rtrain.ce_loss(rc, p, b), has_aux=True))
    (_, gm), grads = grad_fn(params, rbatch)
    step = jax.jit(rtrain.make_train_step(rc, ocfg, microbatches))
    metrics = []
    for _ in range(steps):
        params, opt, m = step(params, opt, rbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    named = lambda tree: {k: np.asarray(v, np.float32) for k, v in
                          convert.lm_named_from_tree(
                              tc, jax.tree.map(np.asarray, tree)).items()}
    _jax_single.trees[(steps, microbatches, compress, arch)] = \
        jax.tree.map(np.asarray, (params, opt))
    return (metrics, {k: float(v) for k, v in gm.items()}, named(grads),
            named(params), {k: named(opt[k]) for k in opt if k != "step"})


_jax_single.trees = {}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _leaf_gap(port: np.ndarray, ref: np.ndarray) -> float:
    err = float(np.abs(port - ref).max())
    top = float(np.abs(ref).max())
    return err / top if top else (0.0 if err == 0 else np.inf)


# ---------------------------------------------------------------------------
# (i) shards, (vi) bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_each_rank_holds_the_reference_shard(runs, jax_sharded, shape):
    """Each rank's weights have the shape of device r's shard under the
    reference's ``param_specs`` on an 8-device host mesh, and the launcher
    handed it that very piece (``shard_index``, the same slices)."""
    res = runs(shape)["f32"]
    _, _, shards = jax_sharded[shape]
    _, tc = _cfgs()
    mesh = lm_mesh.abstract_mesh(shape)
    specs = lm_mesh.param_specs(tc, mesh)
    full = param_shapes(tc)
    assert set(shards) == set(full)
    for r, rank in enumerate(res.ranks):
        for name, want in shards.items():
            got = rank["shards"][name]
            assert got == [b - a for a, b in want[r]], (r, name)
            idx = lm_mesh.shard_index(specs[name], full[name], mesh, r)
            assert [[s.start, s.stop] for s in idx] == want[r], (r, name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ["f32", "compress-mb2"])
def test_resident_bytes_equal_the_dry_runs_arguments(runs, shape, case):
    """A rank's weights, moments (and error buffer), step and batch rows
    are the dry run's argument bytes a GPU at the same mesh."""
    got = runs(shape)
    _, tc = _cfgs(grad_compress=case == "compress-mb2")
    want = run_cell(tc.name, "train", cfg=tc, mesh_shape=shape, shape_info=dict(
        kind="train", seq_len=S, global_batch=B))["argument_bytes"]
    assert [r["resident_bytes"] for r in got[case].ranks] == \
        [want] * (shape[0] * shape[1])


# ---------------------------------------------------------------------------
# (ii) float32 against the JAX single-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "gemma3"])
@pytest.mark.parametrize("shape", SHAPES)
def test_float32_loss_and_grads_match_jax(runs, shape, case):
    res = runs(shape)[case]
    _, gm, grads, _, _ = _jax_single(arch=CASES[case].get("arch", ARCH))
    assert res.grads_metrics["loss"] == pytest.approx(gm["loss"],
                                                      rel=LOSS_RTOL)
    assert set(res.grads) == set(grads)
    gaps = {k: _leaf_gap(_np(res.grads[k]), g) for k, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    print(f"{shape} {case}: loss {res.grads_metrics['loss']} (jax "
          f"{gm['loss']}); worst gradient leaf {worst} {gaps[worst]:.3g} of "
          f"its largest |g| (bar {GRAD_BAR:g})")
    assert gaps[worst] <= GRAD_BAR, (worst, gaps[worst])


@pytest.mark.parametrize("case", ["f32", "gemma3"])
@pytest.mark.parametrize("shape", SHAPES)
def test_float32_adamw_step_matches_jax(runs, shape, case):
    """The step's loss, grad_norm and lr, then mu, nu and the weights."""
    res = runs(shape)[case]
    metrics, _, _, params, opt = _jax_single(
        arch=CASES[case].get("arch", ARCH))
    for key in ("loss", "grad_norm", "lr"):
        assert res.metrics[0][key] == pytest.approx(metrics[0][key],
                                                    rel=GN_RTOL), key
    lr = metrics[0]["lr"]
    for m, bar in (("mu", GRAD_BAR), ("nu", 2 * GRAD_BAR)):
        for k, v in getattr(res, m).items():
            assert _leaf_gap(_np(v), opt[m][k]) <= bar, (m, k)
    for k, w in res.params.items():
        assert float(np.abs(_np(w) - params[k]).max()) <= 2 * lr, k


@pytest.mark.parametrize("shape", SHAPES)
def test_a_step_from_the_references_state_matches_its_second(runs, shape):
    """Weights and AdamW state handed over as the reference's trees (after
    its first step, ``step`` 1): the mesh's step is the reference's
    second, its lr the schedule's at step 2."""
    res = runs(shape)["resumed"]
    metrics, _, _, params, opt = _jax_single(steps=2)
    for key in ("loss", "grad_norm", "lr"):
        assert res.metrics[0][key] == pytest.approx(metrics[1][key],
                                                    rel=GN_RTOL), key
    lr = metrics[1]["lr"]
    for m in ("mu", "nu"):
        for k, v in getattr(res, m).items():
            assert _leaf_gap(_np(v), opt[m][k]) <= 1e-3, (m, k)
    for k, w in res.params.items():
        assert float(np.abs(_np(w) - params[k]).max()) <= 2 * lr, k


# ---------------------------------------------------------------------------
# (iii) bf16 against the JAX sharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_the_jax_sharded_step(runs, jax_sharded, shape):
    res = runs(shape)["bf16"]
    loss, params, _ = jax_sharded[shape]
    gap = abs(res.metrics[0]["loss"] - loss)
    worst = max(res.params, key=lambda k: float(np.abs(
        _np(res.params[k]) - params[k]).max()))
    pgap = float(np.abs(_np(res.params[worst]) - params[worst]).max())
    print(f"{shape} bf16: loss {res.metrics[0]['loss']} (jax sharded {loss},"
          f" gap {gap:.3g}, bar {BF16_LOSS:g}); worst weight {worst} "
          f"{pgap:.3g} (bar {BF16_PARAM:g})")
    assert gap < BF16_LOSS
    assert pgap < BF16_PARAM


# ---------------------------------------------------------------------------
# (iv) microbatches and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_microbatches_and_compression_match_jax(runs, shape):
    """microbatches=2 (each global slice split over 'data') and
    grad_compress=True (a scale a leaf over every shard), two steps,
    against the reference's single-device step with the same settings:
    the loss (the last global slice's) and grad_norm a step; the error
    buffer within 254 · GRAD_BAR of its largest |err| but where a code
    moved by one (at most 1e-3 of the elements); mu within 1e-2 and nu
    within 2e-2 of their largest; each weight within 2 · lr a step."""
    res = runs(shape)["compress-mb2"]
    metrics, _, _, params, opt = _jax_single(steps=2, microbatches=2,
                                             compress=True)
    for step, (m, rm) in enumerate(zip(res.metrics, metrics)):
        for key in ("loss", "grad_norm"):
            assert m[key] == pytest.approx(rm[key], rel=GN_RTOL), (step, key)
    flips = total = 0
    for k, v in res.err.items():
        d, top = np.abs(_np(v) - opt["err"][k]), float(
            np.abs(opt["err"][k]).max())
        bar = 254 * GRAD_BAR * top
        flips += int((d > bar).sum())
        total += d.size
        assert float(d.max()) <= 2 * top + bar, k
    print(f"{shape} compress + microbatches: {flips} of {total} codes "
          "differ after 2 steps")
    assert flips <= 1e-3 * total
    for m, bar in (("mu", 1e-2), ("nu", 2e-2)):
        for k, v in getattr(res, m).items():
            assert _leaf_gap(_np(v), opt[m][k]) <= bar, (m, k)
    lr = max(m["lr"] for m in metrics)
    for k, w in res.params.items():
        assert float(np.abs(_np(w) - params[k]).max()) <= 2 * lr * 2, k


# ---------------------------------------------------------------------------
# (v) remat and reproducibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_remat_gives_the_same_bits(runs, shape):
    """Recomputing each group in the backward re-issues its gathers and
    all-reduces in the same order on every rank: the same gradients and
    weights, bit for bit."""
    got = runs(shape)
    plain, remat = got["f32"], got["f32-remat"]
    for tree in ("grads", "params"):
        a, b = getattr(plain, tree), getattr(remat, tree)
        assert all(torch.equal(a[k], b[k]) for k in a), tree


@pytest.mark.parametrize("shape", SHAPES)
def test_two_runs_give_the_same_bits(runs, shape):
    """The f32 case runs twice from the same state on every rank: the same
    loss, weights, mu and nu, bit for bit."""
    res = runs(shape)["f32"]
    for rank in res.ranks:
        (again,) = rank["repeats"]
        assert again["differ"] == []
        assert again["metrics"] == res.metrics


@pytest.mark.parametrize("shape", SHAPES)
def test_replicated_leaves_agree_over_the_grid(runs, shape):
    """The norms are replicated over both axes: every rank's copy after
    the step holds the same bits (``gather_named`` refuses a differing
    copy), and their gradients too."""
    res = runs(shape)["bf16"]
    assert "final_norm" in res.params and "layers.0.ln1" in res.params
    assert runs(shape)["f32"].grads["layers.1.ln2"].abs().max() > 0


# ---------------------------------------------------------------------------
# pieces without a spawn
# ---------------------------------------------------------------------------

def test_one_rank_grid_is_the_one_process_step():
    """A (1, 1) grid runs the one-process arithmetic: the rank's step
    equals ``make_train_step`` on the whole model bit for bit."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.training.train import init_train_state, make_train_step

    _, tc = _cfgs("bf16")
    model = Transformer(tc, {k: v.clone() for k, v in
                             _port_params("bf16").items()})
    step = make_train_step(tc, _opt_cfgs()[1])
    model, _, m = step(model, init_train_state(tc, model), _batch())
    res = lm_mesh.run_train_mesh(tc, _port_params("bf16"), None, _batch(),
                                 (1, 1), device="cpu", opt_cfg=_opt_cfgs()[1],
                                 keep=("params",), timeout=TIMEOUT)
    assert res.metrics[0]["loss"] == float(m["loss"])
    assert all(torch.equal(res.params[k], p)
               for k, p in model.named_parameters())
    assert res.ranks[0]["bytes"] == dict.fromkeys(lm_mesh.GRID_BYTES, 0)


def test_shard_and_gather_round_trip():
    _, tc = _cfgs()
    mesh = lm_mesh.abstract_mesh((2, 4))
    specs = lm_mesh.param_specs(tc, mesh)
    named = _named()
    ranks = [convert.shard_named(named, specs, mesh, r) for r in range(8)]
    assert ranks[5]["layers.0.attn.wk"].shape == (32, 8)
    assert np.array_equal(ranks[5]["layers.0.attn.wk"],
                          named["layers.0.attn.wk"][32:64, 8:16])
    back = convert.gather_named(ranks, specs, mesh)
    assert all(np.array_equal(back[k], named[k]) for k in named)
    ranks[6]["final_norm"] = ranks[6]["final_norm"] + 1
    with pytest.raises(ValueError, match="another copy"):
        convert.gather_named(ranks, specs, mesh)


class _Grid:
    def __init__(self, model):
        self.model = model

    def size(self, axis):
        return self.model if axis == "model" else 2


def test_grid_refuses_what_it_does_not_run():
    """What a grid still refuses: a 'model' axis that splits a query head
    (minitron's 4 at 8) or an SSM head (mamba2's 8 at 16). Every layer
    kind runs now (MoE, MLA, SSM, cross and encoder layers), and so does a
    vocab that 'model' does not divide (its table then runs whole)."""
    for arch in ("deepseek-v2-lite-16b", "mamba2-2.7b", "whisper-large-v3"):
        check_grid(tcfg.get_config(arch).reduced(), _Grid(2))
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="splits a query head"):
        check_grid(tc, _Grid(8))
    ssm = tcfg.get_config("mamba2-2.7b").reduced()
    with pytest.raises(ValueError, match="splits an SSM head"):
        check_grid(ssm, _Grid(16))
    odd = dataclasses.replace(tc, vocab=250)
    specs = lm_mesh.param_specs(odd, lm_mesh.abstract_mesh((2, 4)))
    assert "model" not in specs["embed"]
    check_grid(odd, _Grid(4))


def test_launcher_refusals():
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        lm_mesh.run_train_mesh(tc, _port_params(), None, _batch(), (1, 2),
                               device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="keep"):
        lm_mesh.run_train_mesh(tc, _port_params(), None, _batch(), (1, 2),
                               device="cpu", keep=("moments",))


def test_a_failing_rank_fails_the_run():
    """A rank that raises (here every rank: 3 query heads on a 'model'
    axis of 2) fails the run with its log, and no rank is left behind."""
    _, tc = _cfgs()
    cfg = dataclasses.replace(tc, n_heads=3, n_kv_heads=1)
    arrays = {k: torch.zeros(s, dtype=cfg.dtype)
              for k, s in param_shapes(cfg).items()}
    with pytest.raises(MeshFailed, match="splits a query head"):
        lm_mesh.run_train_mesh(cfg, arrays, None, synthetic_batch(
            cfg, 0, 8, 2, device="cpu"), (1, 2), device="cpu",
            timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# (vii) the import pin
# ---------------------------------------------------------------------------

def test_mesh_modules_import_neither_jax_nor_repro():
    """The modules the mesh step runs, and the rank's entry, in a fresh
    interpreter: neither jax nor the JAX package is loaded, and no process
    group is started by an import."""
    code = (
        "import sys, torch.distributed as dist\n"
        "import repro_torch.launch.lm_mesh, repro_torch.models.sharding\n"
        "import repro_torch.models.transformer, repro_torch.convert\n"
        "import repro_torch.training.train, repro_torch.models.moe\n"
        "import repro_torch.models.ssm, repro_torch.models.attention\n"
        "import repro_torch.models.layers, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
