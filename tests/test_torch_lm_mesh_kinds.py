"""The port's LM train step on a (data, model) process mesh for every layer
kind other than dense GQA (``launch/lm_mesh.py::run_train_mesh``, gloo ranks
on the CPU) against the JAX package's single-device step: MoE with expert
parallelism and the reference's global capacity (deepseek-v2-lite-16b,
with MLA and shared experts; qwen3-moe-235b-a22b), Mamba2 heads
(mamba2-2.7b), Hymba's hybrid layers, Whisper's encoder and decoder
cross-attention, and the VLM's cross layers, all reduced (d 64, 4 heads).

One spawn a mesh shape runs every case of that shape (a module fixture).
The weights are drawn with numpy from seed 0 and carried to both packages
(``convert``); the batch is ``synthetic_batch(cfg, 0, 32, 8)``, its media
included. Two changes to the reduced configs, made on both sides
(``OVERRIDES``): the MoE archs route with a capacity factor of 1.0, so that
experts overflow and a capacity a data rank would drop other copies than
the global one; Whisper's vocab is 250 and Hymba's 255, which a 'model'
axis of 4 does not divide (as 51,866 and 32,001 at full width), so their
tables run whole over 'model' (Whisper's is split at (2, 2)).

Bars, those of tests/test_torch_lm_mesh.py: the loss within rtol 1e-6,
each gradient leaf within 1e-5 of its largest |g|, grad_norm within rtol
1e-5, mu within the gradient bar of its largest |mu| and nu twice it, each
weight within 2 · lr. Each MoE layer's dropped copies equal the
reference's exactly. tests/test_torch_lm_mesh_kinds_sharded.py holds the
bf16 step to the reference's sharded step and the shards to its devices'.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models.transformer as rt
import repro.training.optimizer as ropt
import repro.training.train as rtrain
import repro_torch.configs as tcfg
import repro_torch.training.optimizer as topt
from repro.data.tokens import synthetic_batch as ref_batch
from repro_torch import convert
from repro_torch.data.tokens import synthetic_batch
from repro_torch.launch import lm_mesh
from repro_torch.launch.dryrun import run_cell
from repro_torch.models.transformer import (
    check_grid, param_dtype, param_shapes,
)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
         "hymba-1.5b", "whisper-large-v3", "llama-3.2-vision-90b")
MOE = ARCHS[:2]
#: the reduced configs' changes, on both sides (the module's docstring)
OVERRIDES = {"deepseek-v2-lite-16b": dict(capacity_factor=1.0),
             "qwen3-moe-235b-a22b": dict(capacity_factor=1.0),
             "hymba-1.5b": dict(vocab=255),
             "whisper-large-v3": dict(vocab=250)}
SHAPES = ((2, 4), (2, 2))
B, S = 8, 32
TOTAL_STEPS = 10
LOSS_RTOL, GRAD_BAR, GN_RTOL = 1e-6, 1e-5, 1e-5
TIMEOUT = 300.0


def cfgs(arch, dtype="f32", **kw):
    """(reference config, port config), reduced, with ``OVERRIDES``,
    float32 unless bf16."""
    out = []
    for reg, f32 in ((rcfg, jnp.float32), (tcfg, torch.float32)):
        cfg = dataclasses.replace(reg.get_config(arch).reduced(),
                                  **OVERRIDES.get(arch, {}), **kw)
        if dtype == "f32":
            cfg = dataclasses.replace(cfg, dtype=f32)
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def named(arch, dtype="f32") -> dict:
    """Every weight, ``{port name: float32 array}``, from numpy seed 0:
    N(0, 0.02), norms included; rounded to bf16 for ``dtype="bf16"``."""
    _, tc = cfgs(arch, dtype)
    rng = np.random.default_rng(0)
    out = {}
    for k, shape in param_shapes(tc).items():
        a = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        if dtype == "bf16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out[k] = a
    return out


def port_params(arch, dtype="f32") -> dict:
    """``named`` as the port's tensors, each in its leaf's dtype."""
    _, tc = cfgs(arch, dtype)
    return {k: torch.tensor(a).to(param_dtype(tc, k))
            for k, a in named(arch, dtype).items()}


def batch(arch) -> dict:
    _, tc = cfgs(arch)
    return synthetic_batch(tc, 0, S, B, device="cpu")


def opt_cfgs():
    kw = dict(total_steps=TOTAL_STEPS)
    return ropt.AdamWConfig(**kw), topt.AdamWConfig(**kw)


def case(arch, dtype="f32", keep=("params", "mu", "nu"), **kw):
    cfg_kw = {k: kw.pop(k) for k in ("remat", "grad_compress") if k in kw}
    _, tc = cfgs(arch, dtype, **cfg_kw)
    return lm_mesh.TrainCase(tc, port_params(arch, dtype), batch(arch),
                             opt_cfg=opt_cfgs()[1], keep=keep, **kw)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def leaf_gap(port: np.ndarray, ref: np.ndarray) -> float:
    err = float(np.abs(port - ref).max())
    top = float(np.abs(ref).max())
    return err / top if top else (0.0 if err == 0 else np.inf)


#: the cases of each spawn beside an f32 case an arch, by name
EXTRA = {
    (2, 4): {"remat": dict(arch="deepseek-v2-lite-16b",
                           keep=("params", "grads"), remat=True)},
    (2, 2): {"compress-mb2": dict(arch="deepseek-v2-lite-16b",
                                  keep=("params", "mu", "nu", "err"),
                                  steps=2, microbatches=2,
                                  grad_compress=True)},
}
#: the f32 case run twice from the same state on every rank
REPEATED = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def runs():
    """mesh shape -> {case name: TrainResult}, one spawn a shape."""
    done = {}

    def get(shape):
        if shape not in done:
            names = list(ARCHS) + list(EXTRA[shape])
            cases = [case(a, keep=("params", "mu", "nu", "grads"),
                          repeats=2 if a == REPEATED and shape == (2, 4)
                          else 1) for a in ARCHS]
            cases += [case(**kw) for kw in EXTRA[shape].values()]
            run = lm_mesh.run_lm_mesh_cases(cases, shape, device="cpu",
                                            timeout=TIMEOUT)
            done[shape] = dict(zip(names, run.results))
        return done[shape]
    return get


@functools.lru_cache(maxsize=None)
def jax_single(arch, steps=1, microbatches=1, compress=False):
    """The reference's single-device step from the same weights:
    ``(metrics a step, gradients' metrics, gradients of the first step,
    params', opt')``, the last three ``{port name: float32}``."""
    rc, tc = cfgs(arch, grad_compress=compress)
    ocfg, _ = opt_cfgs()
    params = jax.tree.map(lambda a: jnp.asarray(a, rc.dtype),
                          convert.lm_tree_from_named(tc, named(arch)))
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
    as_named = lambda tree: {k: np.asarray(v, np.float32) for k, v in
                             convert.lm_named_from_tree(
                                 tc, jax.tree.map(np.asarray, tree)).items()}
    return (metrics, {k: float(v) for k, v in gm.items()}, as_named(grads),
            as_named(params), {k: as_named(opt[k]) for k in opt
                               if k != "step"})


@functools.lru_cache(maxsize=None)
def jax_routing(arch):
    """Each MoE layer of the reference's forward on the initial weights, in
    stack order: ``(dropped copies, experts (T, k))``, the forward run
    eagerly and unrolled with ``moe_ffn`` wrapped to record them."""
    rc, tc = cfgs(arch)
    rc = dataclasses.replace(rc, scan_layers=False)
    params = jax.tree.map(lambda a: jnp.asarray(a, rc.dtype),
                          convert.lm_tree_from_named(tc, named(arch)))
    log, real = [], rt.moe_ffn

    def wrapped(p, x, **kw):
        y, (aux, dropped) = real(p, x, **kw)
        probs = jax.nn.softmax(
            x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            @ p["router"].astype(jnp.float32), axis=-1)
        n = x.shape[0] * x.shape[1] * kw["topk"]
        log.append((round(float(dropped) * n),
                    np.asarray(jax.lax.top_k(probs, kw["topk"])[1])))
        return y, (aux, dropped)

    with mock.patch.object(rt, "moe_ffn", wrapped):
        rtrain.ce_loss(rc, params, ref_batch(rc, 0, S, B))
    return log


def capacity_drops(eidx: np.ndarray, E: int, cf: float, parts: int) -> int:
    """The copies a capacity computed over each of ``parts`` contiguous
    slices of the tokens would drop (``parts`` = 1: the reference's
    global capacity), slots counted in token order as the reference's."""
    out = 0
    for sl in np.split(eidx, parts):
        C = int(cf * sl.shape[1] * sl.shape[0] / E) + 1
        counts = np.bincount(sl.reshape(-1), minlength=E)
        out += int(np.maximum(counts - C, 0).sum())
    return out


# ---------------------------------------------------------------------------
# float32 against the JAX single-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_float32_loss_and_grads_match_jax(runs, shape, arch):
    res = runs(shape)[arch]
    _, gm, grads, _, _ = jax_single(arch)
    assert res.grads_metrics["loss"] == pytest.approx(gm["loss"],
                                                      rel=LOSS_RTOL)
    assert res.grads_metrics["aux"] == pytest.approx(gm["aux"],
                                                     rel=LOSS_RTOL, abs=0)
    assert set(res.grads) == set(grads)
    gaps = {k: leaf_gap(_np(res.grads[k]), g) for k, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    print(f"{shape} {arch}: loss {res.grads_metrics['loss']} (jax "
          f"{gm['loss']}); worst gradient leaf {worst} {gaps[worst]:.3g} of "
          f"its largest |g| (bar {GRAD_BAR:g})")
    assert gaps[worst] <= GRAD_BAR, (worst, gaps[worst])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_float32_adamw_step_matches_jax(runs, shape, arch):
    """The step's loss, aux, grad_norm and lr, then mu, nu and the
    weights."""
    res = runs(shape)[arch]
    metrics, _, _, params, opt = jax_single(arch)
    for key in ("loss", "aux", "grad_norm", "lr"):
        assert res.metrics[0][key] == pytest.approx(metrics[0][key],
                                                    rel=GN_RTOL), key
    lr = metrics[0]["lr"]
    for m, bar in (("mu", GRAD_BAR), ("nu", 2 * GRAD_BAR)):
        for k, v in getattr(res, m).items():
            assert leaf_gap(_np(v), opt[m][k]) <= bar, (m, k)
    for k, w in res.params.items():
        assert float(np.abs(_np(w) - params[k]).max()) <= 2 * lr, k


# ---------------------------------------------------------------------------
# MoE: the global capacity, drops layer by layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_drops_equal_the_references_layer_by_layer(runs, shape, arch):
    """Each MoE layer's dropped copies, in the gradient pass and in the
    step (both on the initial weights), equal the reference's forward's,
    layer by layer. On this batch a capacity computed a data rank (half the
    tokens each) would drop other counts: the reference's routing shows
    it, so a per-rank design fails here."""
    res = runs(shape)[arch]
    rc, _ = cfgs(arch)
    log = jax_routing(arch)
    want = [n for n, _ in log]
    D = shape[0]
    per_rank = [capacity_drops(e, rc.n_experts, rc.capacity_factor, D)
                for _, e in log]
    assert [capacity_drops(e, rc.n_experts, rc.capacity_factor, 1)
            for _, e in log] == want
    print(f"{shape} {arch}: dropped a layer {want} of {B * S * rc.topk} "
          f"copies; a capacity a data rank would drop {per_rank}")
    assert res.grads_metrics["dropped"] == want
    assert res.metrics[0]["dropped"] == want
    assert per_rank != want
    assert sum(want) > 0


# ---------------------------------------------------------------------------
# microbatches and compression; remat and reproducibility
# ---------------------------------------------------------------------------

def test_microbatches_and_compression_match_jax(runs):
    """deepseek-v2-lite at (2, 2), microbatches=2 (each global slice split
    over 'data': the capacity is the slice's global T) and grad_compress,
    two steps, against the reference's single-device step with the same
    settings, under tests/test_torch_lm_mesh.py's bars for the case."""
    res = runs((2, 2))["compress-mb2"]
    metrics, _, _, params, opt = jax_single("deepseek-v2-lite-16b", steps=2,
                                            microbatches=2, compress=True)
    for step, (m, rm) in enumerate(zip(res.metrics, metrics)):
        for key in ("loss", "aux", "grad_norm"):
            assert m[key] == pytest.approx(rm[key], rel=GN_RTOL), (step, key)
    flips = total = 0
    for k, v in res.err.items():
        d, top = np.abs(_np(v) - opt["err"][k]), float(
            np.abs(opt["err"][k]).max())
        bar = 254 * GRAD_BAR * top
        flips += int((d > bar).sum())
        total += d.size
        assert float(d.max()) <= 2 * top + bar, k
    print(f"compress + microbatches: {flips} of {total} codes differ after "
          "2 steps")
    assert flips <= 1e-3 * total
    for m, bar in (("mu", 1e-2), ("nu", 2e-2)):
        for k, v in getattr(res, m).items():
            assert leaf_gap(_np(v), opt[m][k]) <= bar, (m, k)
    lr = max(m["lr"] for m in metrics)
    for k, w in res.params.items():
        assert float(np.abs(_np(w) - params[k]).max()) <= 2 * lr * 2, k


def test_remat_gives_the_same_bits_on_a_moe_arch(runs):
    """deepseek-v2-lite at (2, 4): recomputing each group in the backward
    re-issues its gathers, its counts' all_gather and its experts' join in
    the same order on every rank: the same gradients and weights."""
    got = runs((2, 4))
    plain, remat = got[REPEATED], got["remat"]
    for tree in ("grads", "params"):
        a, b = getattr(plain, tree), getattr(remat, tree)
        assert all(torch.equal(a[k], b[k]) for k in a), tree


def test_two_runs_give_the_same_bits_on_a_moe_arch(runs):
    res = runs((2, 4))[REPEATED]
    for rank in res.ranks:
        (again,) = rank["repeats"]
        assert again["differ"] == []
        assert again["metrics"] == res.metrics


# ---------------------------------------------------------------------------
# bytes and whole-over-'model' leaves
# ---------------------------------------------------------------------------

def _cell(arch, shape, **kw):
    """The dry run's cell of a case: the batch's media length given."""
    _, tc = cfgs(arch, **kw)
    info = dict(kind="train", seq_len=S, global_batch=B)
    if tc.n_media_tokens:
        info["media_len"] = tc.n_media_tokens
    return run_cell(tc.name, "train", cfg=tc, mesh_shape=shape,
                    shape_info=info)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_resident_bytes_equal_the_dry_runs_arguments(runs, shape, arch):
    """A rank's weights, moments, step and batch rows (media included)
    are the dry run's argument bytes a GPU at the same mesh."""
    res = runs(shape)[arch]
    want = _cell(arch, shape)["argument_bytes"]
    assert [r["resident_bytes"] for r in res.ranks] == \
        [want] * (shape[0] * shape[1])


def test_resident_bytes_with_the_error_buffer(runs):
    res = runs((2, 2))["compress-mb2"]
    want = _cell("deepseek-v2-lite-16b", (2, 2),
                 grad_compress=True)["argument_bytes"]
    assert [r["resident_bytes"] for r in res.ranks] == [want] * 4


@pytest.mark.parametrize("shape,rows", [((2, 4), 250), ((2, 2), 125)])
def test_a_vocab_model_does_not_divide_runs_whole(runs, shape, rows):
    """Whisper's 250-row table: 'model' of 4 does not divide it, so each
    rank holds all of its rows (its columns over 'data') and runs the
    embedding, the logits and the loss whole; at (2, 2) it is split.
    Hymba's 255 rows (tied) run whole at both."""
    got = runs(shape)
    assert got["whisper-large-v3"].ranks[0]["shards"]["embed"] == [rows, 32]
    assert got["whisper-large-v3"].ranks[0]["shards"]["unembed"] == [rows, 32]
    assert got["hymba-1.5b"].ranks[0]["shards"]["embed"] == [255, 32]


# ---------------------------------------------------------------------------
# refusals, without a spawn
# ---------------------------------------------------------------------------

class _Grid:
    def __init__(self, model):
        self.model = model

    def size(self, axis):
        return self.model if axis == "model" else 2


@pytest.mark.parametrize("arch,model,refused", [
    ("deepseek-v2-lite-16b", 4, None),
    ("qwen3-moe-235b-a22b", 4, None),
    ("mamba2-2.7b", 8, None),  # 8 SSM heads; its one query head is unused
    ("mamba2-2.7b", 16, "SSM head"),
    ("hymba-1.5b", 4, None),
    ("hymba-1.5b", 8, "query head"),
    ("whisper-large-v3", 4, None),
    ("llama-3.2-vision-90b", 3, "query head"),
])
def test_check_grid_refuses_only_a_split_head(arch, model, refused):
    """Every kind runs; a 'model' axis that splits a query or SSM head is
    refused, and the error says which."""
    _, tc = cfgs(arch)
    if refused is None:
        check_grid(tc, _Grid(model))
    else:
        with pytest.raises(ValueError, match=refused):
            check_grid(tc, _Grid(model))


def test_full_width_hymba_needs_a_model_axis_of_five():
    """hymba-1.5b at full width: 25 query heads, 50 SSM heads, 32,001 vocab
    rows and 6,482 in_proj columns; 'model' of 4 splits a query head, of 5
    runs (the vocab and in_proj then whole over 'model')."""
    cfg = tcfg.get_config("hymba-1.5b")
    for m, ok in ((4, False), (5, True)):
        specs = lm_mesh.param_specs(cfg, lm_mesh.abstract_mesh((2, m)))
        if ok:
            check_grid(cfg, _Grid(m))
            assert "model" not in specs["embed"]
            assert "model" not in specs["layers.0.ssm.in_proj"]
        else:
            with pytest.raises(ValueError, match="25 query heads"):
                check_grid(cfg, _Grid(m))


def test_mesh_kind_modules_import_neither_jax_nor_repro():
    """The modules the mesh step runs for these kinds, in a fresh
    interpreter: neither jax nor the JAX package is loaded."""
    code = (
        "import sys\n"
        "import repro_torch.launch.lm_mesh, repro_torch.models.moe\n"
        "import repro_torch.models.ssm, repro_torch.models.attention\n"
        "import repro_torch.models.layers, repro_torch.models.transformer\n"
        "import repro_torch.training.train, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
