"""The port's LM training against the JAX package's, on the CPU at reduced
size: the optimizer, the compressor and the schedule on seeded numpy
leaves, then every arch's loss, gradients and AdamW steps over the same
weights (carried by ``convert``) and the same ``synthetic_batch``.

Bars. float32: the loss within rtol 1e-6; each gradient leaf within 1e-5
of that leaf's largest |g| (``GRAD_BAR``); ``grad_norm`` within rtol 1e-5;
``mu`` after the first step within the gradient bar of its leaf's
largest |mu| and ``nu`` within twice it (nu is quadratic in g); after
later steps, whose gradients are taken at weights that already differ
(below), within ``MOMENT_BAR`` and twice it. The weights after a step: the
first AdamW steps move an element by about ``lr · g / (|g| + eps)``, so an
element whose gradient is within the gradient bar of zero may move by lr
the other way, on either side: every element within ``2 · lr`` a step.
An element whose reference gradient is at least ``RESOLVED`` of its
leaf's largest |g| at every step is resolved: its relative gradient error
is at most ``GRAD_BAR / RESOLVED``, and it stays within ``lr · steps ·
GRAD_BAR / RESOLVED``. bf16: the loss within rtol 1e-4, each gradient leaf
within 0.1 of its largest |g|, the gap printed.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models.transformer as rt
import repro.training.compress as rcomp
import repro.training.optimizer as ropt
import repro.training.train as rtrain
import repro_torch.configs as tcfg
import repro_torch.models.moe as tmoe
import repro_torch.training.compress as tcomp
import repro_torch.training.optimizer as topt
import repro_torch.training.train as ttrain
from repro.data.tokens import synthetic_batch as ref_batch
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_params as ref_init
from repro_torch import convert
from repro_torch.data.tokens import synthetic_batch
from repro_torch.models.transformer import layer_specs
from repro_torch.serving.cache import make_caches
from repro_torch.serving.engine import decode_step, greedy_generate, prefill

torch.set_num_threads(1)

ALL_ARCHS = sorted(rcfg.ARCHS)
BF16_ARCHS = ["deepseek-v2-lite-16b", "minitron-4b", "whisper-large-v3"]
LOSS_RTOL, GRAD_BAR, GN_RTOL = 1e-6, 1e-5, 1e-5
RESOLVED = 1e-3
MOMENT_BAR = 1e-3
BF16_LOSS_RTOL, BF16_GRAD_BAR = 1e-4, 0.1
BF16_TIE = 1e-2  # router probabilities this close may order otherwise
LR = 1e-3
B, S = 2, 32
STEPS = 3


def _cfgs(name, dtype=None, **kw):
    """(reference config, port config), reduced, float32 unless ``dtype``
    is "bf16", with the fields in ``kw`` replaced."""
    out = []
    for reg, f32 in ((rcfg, jnp.float32), (tcfg, torch.float32)):
        cfg = reg.get_config(name).reduced()
        if dtype != "bf16":
            cfg = dataclasses.replace(cfg, dtype=f32)
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _opt_cfgs(**kw):
    kw = {"lr": LR, "warmup_steps": 1, "total_steps": 30, **kw}
    return ropt.AdamWConfig(**kw), topt.AdamWConfig(**kw)


def _np(t: torch.Tensor) -> np.ndarray:
    """A float32 copy: the step writes weights and moments in place."""
    return t.detach().float().numpy().copy()


def _named(tc, tree) -> dict:
    """A reference tree as ``{port name: float32 array}``."""
    return {k: np.asarray(v, np.float32) for k, v in
            convert.lm_named_from_tree(tc, jax.tree.map(np.asarray,
                                                        tree)).items()}


def _leaf_gap(port: np.ndarray, ref: np.ndarray) -> float:
    """max |port - ref| over the leaf's largest |ref| (0 for a zero leaf
    matched exactly)."""
    err = float(np.abs(port - ref).max())
    top = float(np.abs(ref).max())
    return err / top if top else (0.0 if err == 0 else np.inf)


# ---------------------------------------------------------------------------
# the optimizer and the compressor on seeded leaves
# ---------------------------------------------------------------------------

def _leaves(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"a": (37, 5), "b": (300,), "c": (4, 3, 2)}
    return {k: (rng.standard_normal(s) * 0.05).astype(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("warmup,total", [(1, 30), (5, 30), (100, 10_000)])
def test_schedule_matches_reference(warmup, total):
    rc, tc = _opt_cfgs(warmup_steps=warmup, total_steps=total)
    for step in range(0, 2 * total + 3, max(total // 15, 1)):
        ref = float(ropt.schedule(rc, jnp.int32(step)))
        port = float(topt.schedule(tc, torch.tensor(step, dtype=torch.int32)))
        assert port == pytest.approx(ref, rel=1e-6, abs=1e-12), step


def test_global_norm_matches_reference():
    leaves = _leaves(0)
    ref = float(ropt.global_norm(leaves))
    port = topt.global_norm({k: torch.from_numpy(v) for k, v in
                             leaves.items()})
    assert port.dtype == torch.float32
    assert float(port) == pytest.approx(ref, rel=1e-6)


def test_global_norm_adds_chunks_of_a_large_leaf(monkeypatch):
    """A leaf longer than ``CHUNK`` is squared and summed a chunk at a
    time: the same norm within float32 rounding."""
    leaves = _leaves(1)
    want = float(topt.global_norm({k: torch.from_numpy(v)
                                   for k, v in leaves.items()}))
    monkeypatch.setattr(topt, "CHUNK", 7)
    got = float(topt.global_norm({k: torch.from_numpy(v)
                                  for k, v in leaves.items()}))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("chunk", [1 << 26, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, chunk, monkeypatch):
    """Two AdamW steps over seeded weights (float32 or bf16; the moments
    float32) with seeded gradients large enough to clip, whole leaves or a
    chunk of 7 elements at a time: mu and nu within 1e-6 of their leaf's
    largest value (the clip scale may differ by a rounding), the weights
    within one rounding of their dtype and ``lr · 1e-4`` (seeded gradients
    sit far from zero), grad_norm and lr within rtol 1e-6."""
    monkeypatch.setattr(topt, "CHUNK", chunk)
    rc, tc = _opt_cfgs(weight_decay=0.1)
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    params = {k: jnp.asarray(v, np_dt) for k, v in _leaves(2).items()}
    port_p = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        getattr(torch, dtype)) for k, v in params.items()}
    rstate, tstate = ropt.init_opt_state(params), topt.init_opt_state(port_p)
    for step in range(2):
        grads = {k: v * 40 for k, v in _leaves(10 + step).items()}
        params, rstate, rstats = ropt.adamw_update(rc, params, grads, rstate)
        port_p, tstate, tstats = topt.adamw_update(
            tc, port_p, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate)
        assert float(rstats["grad_norm"]) > 1.0  # clipped
        for key in ("grad_norm", "lr"):
            assert float(tstats[key]) == pytest.approx(float(rstats[key]),
                                                       rel=1e-6)
        assert int(tstate["step"]) == int(rstate["step"]) == step + 1
        for k in params:
            for m in ("mu", "nu"):
                assert _leaf_gap(_np(tstate[m][k]),
                                 np.asarray(rstate[m][k])) <= 1e-6, (m, k)
            ref = np.asarray(params[k], np.float32)
            ulp = np.spacing(np.abs(ref).astype(np.float32)) * (
                65536 if dtype == "bfloat16" else 1)
            np.testing.assert_array_less(np.abs(_np(port_p[k]) - ref),
                                         ulp + LR * 1e-4, err_msg=k)


def test_adamw_update_is_in_place():
    p = {"w": torch.ones(10, dtype=torch.bfloat16)}
    state = topt.init_opt_state(p)
    mu, w = state["mu"]["w"], p["w"]
    out, state2, _ = topt.adamw_update(topt.AdamWConfig(lr=0.1, warmup_steps=1), p,
                                       {"w": torch.full((10,), 0.5)}, state)
    assert out["w"] is w and state2["mu"]["w"] is mu
    assert not torch.equal(w, torch.ones(10, dtype=torch.bfloat16))
    assert state2["step"].dtype == torch.int32 and int(state2["step"]) == 1


def test_quantize_matches_reference():
    """Codes equal, the scale within rtol 1e-6 and the carried error within
    1e-6 of the scale, over two error-feedback rounds."""
    g = _leaves(3)
    errs_r = rcomp.init_error_buffer(g)
    errs_t = tcomp.init_error_buffer({k: torch.from_numpy(v)
                                      for k, v in g.items()})
    for step in range(2):
        qs, sc, errs_r = rcomp.compress_tree(g, errs_r)
        tq, tsc, errs_t = tcomp.compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, errs_t,
            [[k] for k in g])
        deq_r = rcomp.decompress_tree(qs, sc, g)
        deq_t = tcomp.decompress_tree(tq, tsc)
        for k in g:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(qs[k]))
            assert float(tsc[k]) == pytest.approx(float(sc[k]), rel=1e-6)
            bar = 1e-6 * float(sc[k])
            np.testing.assert_allclose(errs_t[k].numpy(),
                                       np.asarray(errs_r[k]), atol=bar, rtol=0)
            np.testing.assert_allclose(deq_t[k].numpy(), np.asarray(deq_r[k]),
                                       atol=bar, rtol=0)
        g = _leaves(4 + step)


def test_compress_tree_shares_a_scale_over_a_stacked_leaf():
    """Names listed together share one scale: the reference's quantizer
    over their stack (a pattern position's layers are one leaf there)."""
    rng = np.random.default_rng(5)
    layers = [rng.standard_normal((6, 4)).astype(np.float32) * s
              for s in (0.01, 1.0, 0.1)]
    errs = [rng.standard_normal((6, 4)).astype(np.float32) * 1e-3
            for _ in layers]
    q, scale, err = rcomp.quantize(np.stack(layers), np.stack(errs))
    names = [f"layers.{i}.w" for i in range(3)]
    tq, tsc, terr = tcomp.compress_tree(
        {n: torch.from_numpy(a) for n, a in zip(names, layers)},
        {n: torch.from_numpy(e) for n, e in zip(names, errs)}, [names])
    for i, n in enumerate(names):
        np.testing.assert_array_equal(tq[n].numpy(), np.asarray(q)[i])
        assert float(tsc[n]) == pytest.approx(float(scale), rel=1e-6)
        np.testing.assert_allclose(terr[n].numpy(), np.asarray(err)[i],
                                   rtol=0, atol=1e-6 * float(scale))


def test_quantize_rounds_half_to_even_and_clips():
    """``jnp.round``'s ties to even: 0.5 and 2.5 of a code go down, 1.5
    up; the largest |g| maps to ±127 (the scale is 1 here)."""
    g = torch.tensor([0.5, 1.5, 2.5, -127.0, 127.0])
    q, scale, err = tcomp.quantize(g, torch.zeros(5))
    rq, _, _ = rcomp.quantize(jnp.asarray(g.numpy()), jnp.zeros(5))
    assert float(scale) == 1.0
    assert q.tolist() == [0, 2, 2, -127, 127] == np.asarray(rq).tolist()
    assert err.tolist() == [0.5, -0.5, 0.5, 0.0, 0.0]


# ---------------------------------------------------------------------------
# the model's loss and gradients, and AdamW steps, every arch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(name, dtype, microbatches=1, compress=False):
    """The reference's jitted step for one config: ``(metrics, stats,
    grads, params', opt')`` from ``(params, opt, batch)``, one compile an
    arch; with microbatches or compression its ``make_train_step``."""
    rc, _ = _cfgs(name, dtype, grad_compress=compress)
    ocfg, _ = _opt_cfgs()
    if microbatches > 1 or compress:
        return jax.jit(rtrain.make_train_step(rc, ocfg, microbatches))
    grad_fn = jax.value_and_grad(lambda p, b: rtrain.ce_loss(rc, p, b),
                                 has_aux=True)

    def step(p, o, b):
        (_, metrics), grads = grad_fn(p, b)
        p2, o2, stats = ropt.adamw_update(ocfg, p, grads, o)
        return metrics, stats, grads, p2, o2

    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def _runs(name, dtype=None, steps=STEPS):
    """Both packages from the same weights over ``steps`` steps on one
    batch: per step the metrics, the gradients (taken before the step),
    and the weights, mu and nu after it, as numpy."""
    rc, tc = _cfgs(name, dtype)
    params = ref_init(rc, jax.random.key(1))
    model = convert.lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                          device="cpu")
    rbatch = ref_batch(rc, 0, S, B)
    tbatch = synthetic_batch(tc, 0, S, B, device="cpu")
    ropt_state = rtrain.init_train_state(rc, params)
    topt_state = ttrain.init_train_state(tc, model)
    _, ocfg = _opt_cfgs()
    tstep = ttrain.make_train_step(tc, ocfg)
    jstep = _jax_step(name, dtype)
    ref, port = [], []
    for _ in range(steps):
        metrics, stats, grads, params, ropt_state = jstep(params, ropt_state,
                                                          rbatch)
        ref.append(dict(metrics={**metrics, **stats}, grads=_named(tc, grads),
                        params=_named(tc, params),
                        mu=_named(tc, ropt_state["mu"]),
                        nu=_named(tc, ropt_state["nu"])))
        tgrads, _ = ttrain.compute_grads(model, tbatch)
        model, topt_state, tm = tstep(model, topt_state, tbatch)
        port.append(dict(metrics=tm,
                         grads={k: _np(v) for k, v in tgrads.items()},
                         params={k: _np(p) for k, p in
                                 model.named_parameters()},
                         mu={k: _np(v) for k, v in topt_state["mu"].items()},
                         nu={k: _np(v) for k, v in topt_state["nu"].items()}))
    return ref, port


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_float32_loss_and_grads_match_jax(name):
    ref, port = (r[0] for r in _runs(name))
    rl, pl = float(ref["metrics"]["loss"]), float(port["metrics"]["loss"])
    assert pl == pytest.approx(rl, rel=LOSS_RTOL)
    assert float(port["metrics"]["aux"]) == pytest.approx(
        float(ref["metrics"]["aux"]), rel=LOSS_RTOL, abs=1e-7)
    assert float(port["metrics"]["grad_norm"]) == pytest.approx(
        float(ref["metrics"]["grad_norm"]), rel=GN_RTOL)
    assert set(port["grads"]) == set(ref["grads"])
    gaps = {k: _leaf_gap(port["grads"][k], g) for k, g in ref["grads"].items()}
    worst = max(gaps, key=gaps.get)
    print(f"{name} float32: loss {pl} (jax {rl}); worst gradient leaf "
          f"{worst} {gaps[worst]:.3g} of its largest |g| (bar {GRAD_BAR:g})")
    assert gaps[worst] <= GRAD_BAR, (worst, gaps[worst])


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_float32_adamw_steps_match_jax(name):
    """mu, nu and the weights after steps 1 and 3, and each step's loss,
    grad_norm and lr."""
    ref, port = _runs(name)
    resolved = None
    for i, (r, p) in enumerate(zip(ref, port)):
        steps = i + 1
        for key in ("loss", "grad_norm", "lr"):
            assert float(p["metrics"][key]) == pytest.approx(
                float(r["metrics"][key]), rel=GN_RTOL), (steps, key)
        big = {k: np.abs(g) >= RESOLVED * np.abs(g).max()
               for k, g in r["grads"].items()}
        resolved = big if resolved is None else {
            k: resolved[k] & big[k] for k in big}
        if steps not in (1, STEPS):
            continue
        worst = dict(mu=0.0, nu=0.0, all=0.0, resolved=0.0)
        for k, w in r["params"].items():
            worst["mu"] = max(worst["mu"], _leaf_gap(p["mu"][k], r["mu"][k]))
            worst["nu"] = max(worst["nu"], _leaf_gap(p["nu"][k], r["nu"][k]))
            d = np.abs(p["params"][k] - w)
            worst["all"] = max(worst["all"], float(d.max()))
            if resolved[k].any():
                worst["resolved"] = max(worst["resolved"],
                                        float(d[resolved[k]].max()))
        print(f"{name} after step {steps}: {worst}")
        # past step 1 the gradients are taken at weights that differ where
        # an element was unresolved: MOMENT_BAR, not the gradient bar
        bar = GRAD_BAR if steps == 1 else MOMENT_BAR
        assert worst["mu"] <= bar and worst["nu"] <= 2 * bar
        assert worst["all"] <= 2 * LR * steps
        assert worst["resolved"] <= LR * steps * GRAD_BAR / RESOLVED


def _routes(rc, tc, params, model, batch) -> list:
    """Each MoE layer's routing in both packages over the batch, in stack
    order: ``(port experts, reference experts, port gap)``, the experts a
    token's copies go to as sets, and the port's gap between a token's
    k-th and (k+1)-th probabilities."""
    ref, port = [], []
    real_ffn, real_route = rt.moe_ffn, tmoe.route

    def ref_spy(p, x, *, n_experts, topk, **kw):
        logits = jnp.einsum("td,de->te",
                            x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), topk)
        jax.debug.callback(lambda e: ref.append(np.asarray(e)), eidx,
                           ordered=True)
        return real_ffn(p, x, n_experts=n_experts, topk=topk, **kw)

    def port_spy(logits, topk):
        out = real_route(logits, topk)
        top = torch.sort(out[0], dim=-1, descending=True).values
        port.append((out[2], top[:, topk - 1] - top[:, topk]))
        return out

    with mock.patch.object(rt, "moe_ffn", ref_spy), \
            mock.patch.object(tmoe, "route", port_spy):
        jax.block_until_ready(ref_forward(rc, params, batch["tokens"]))
        jax.effects_barrier()
        model(torch.from_numpy(np.asarray(batch["tokens"])))
    return [([set(t) for t in pe.tolist()], [set(t) for t in re.tolist()],
             gap.numpy()) for (pe, gap), re in zip(port, ref)]


@pytest.mark.parametrize("name", BF16_ARCHS)
def test_bf16_loss_and_grads_within_bars(name):
    """In bf16 a token whose k-th and (k+1)-th router probabilities lie
    within bf16's rounding of each other (``BF16_TIE``) may pick another
    expert in the port than in the reference, and then that MoE sublayer's
    gradients (its norm ``ln2``, the router and the experts) hold another
    token's. So for a MoE arch the routing is compared first: a token
    routed differently must be such a near tie, and that sublayer's leaves
    are printed, not held; every other leaf is held to the bar."""
    rc, tc = _cfgs(name, "bf16")
    ref, port = (r[0] for r in _runs(name, "bf16", steps=1))
    rl, pl = float(ref["metrics"]["loss"]), float(port["metrics"]["loss"])
    free = []  # the MoE sublayers where a token was routed otherwise
    if tc.n_experts:
        params = ref_init(rc, jax.random.key(1))
        model = convert.lm_params_from_arrays(
            tc, jax.tree.map(np.asarray, params), device="cpu")
        moe_layers = [i for i, s in enumerate(layer_specs(tc))
                      if s.ffn == "moe"]
        routes = _routes(rc, tc, params, model, ref_batch(rc, 0, S, B))
        assert len(routes) == len(moe_layers)
        for i, (pe, re, gap) in zip(moe_layers, routes):
            moved = [t for t in range(len(pe)) if pe[t] != re[t]]
            print(f"{name} bf16 layer {i}: tokens routed otherwise {moved}, "
                  f"their gaps {gap[moved]}")
            assert all(gap[t] < BF16_TIE for t in moved), (i, moved)
            if moved:
                free += [f"layers.{i}.ln2", f"layers.{i}.ffn."]
    gaps = {}
    for k, g in ref["grads"].items():
        gap = _leaf_gap(port["grads"][k], g)
        if any(k.startswith(f) for f in free):
            print(f"{k}: not held, gap {gap:.3g}")
        else:
            gaps[k] = gap
    worst = max(gaps, key=gaps.get)
    print(f"{name} bf16: loss {pl} (jax {rl}, rel {abs(pl - rl) / rl:.3g}); "
          f"worst gradient leaf {worst} {gaps[worst]:.3g} of its largest |g| "
          f"(bar {BF16_GRAD_BAR:g})")
    assert pl == pytest.approx(rl, rel=BF16_LOSS_RTOL)
    assert gaps[worst] <= BF16_GRAD_BAR, (worst, gaps[worst])


def test_microbatches_match_the_reference_scan():
    """microbatches=2 over B = 4: the weights and moments after a step
    against the reference's ``lax.scan`` of two slices, and the reported
    loss is the last slice's (the scan's carry), not the batch's."""
    name = "deepseek-v2-lite-16b"  # MoE: its aux is reported too
    rc, tc = _cfgs(name)
    params = ref_init(rc, jax.random.key(2))
    model = convert.lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                          device="cpu")
    rbatch, tbatch = ref_batch(rc, 0, S, 4), synthetic_batch(tc, 0, S, 4,
                                                             device="cpu")
    _, ocfg = _opt_cfgs()
    last = {k: v[2:] for k, v in tbatch.items()}
    _, want_last = ttrain.ce_loss(model, last)
    _, want_all = ttrain.ce_loss(model, tbatch)
    p2, o2, rm = _jax_step(name, None, microbatches=2)(
        params, rtrain.init_train_state(rc, params), rbatch)
    model, opt, tm = ttrain.make_train_step(tc, ocfg, microbatches=2)(
        model, ttrain.init_train_state(tc, model), tbatch)
    for key in ("loss", "aux", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(rm[key]), rel=GN_RTOL)
    assert float(tm["loss"]) == pytest.approx(float(want_last["loss"]),
                                              rel=LOSS_RTOL)
    assert float(tm["loss"]) != pytest.approx(float(want_all["loss"]),
                                              rel=1e-4)
    for m in ("mu", "nu"):
        ref = _named(tc, o2[m])
        for k, v in opt[m].items():
            assert _leaf_gap(_np(v), ref[k]) <= (
                GRAD_BAR if m == "mu" else 2 * GRAD_BAR), (m, k)
    ref = _named(tc, p2)
    for k, w in model.named_parameters():
        assert float(np.abs(_np(w) - ref[k]).max()) <= 2 * LR, k


def test_microbatches_refuse_an_uneven_batch():
    _, tc = _cfgs("minitron-4b")
    model = convert.lm_params_from_arrays(
        tc, jax.tree.map(np.asarray, ref_init(_cfgs("minitron-4b")[0],
                                              jax.random.key(0))),
        device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.compute_grads(model, synthetic_batch(tc, 0, 8, 3, device="cpu"),
                             microbatches=2)


def test_grad_compress_matches_the_reference():
    """grad_compress=True: two steps; the error buffer after them, the
    weights and the moments against the reference's. A pattern position's
    layers share one scale, as their stacked leaf does in the reference.
    The error is the gradient less its code times the scale (max|g| / 127),
    so it is held within ``254 · GRAD_BAR`` of its leaf's largest |err|,
    except where a code differs (the gradient within the bar of a rounding
    boundary): there it moves by one scale, at most twice the largest
    |err|, at no more than 1e-3 of the elements. Such a code moves ``mu``
    by (1 - b1) / 127 of the largest |g|: mu within 1e-2 of its leaf's
    largest |mu|, nu within 2e-2."""
    name = "minitron-4b"
    rc, tc = _cfgs(name, grad_compress=True)
    params = ref_init(rc, jax.random.key(3))
    model = convert.lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                          device="cpu")
    rbatch = ref_batch(rc, 0, S, B)
    tbatch = synthetic_batch(tc, 0, S, B, device="cpu")
    _, ocfg = _opt_cfgs()
    ropt_state = rtrain.init_train_state(rc, params)
    topt_state = ttrain.init_train_state(tc, model)
    assert set(topt_state) == set(ropt_state) == {"mu", "nu", "step", "err"}
    jstep = _jax_step(name, None, compress=True)
    tstep = ttrain.make_train_step(tc, ocfg)
    for _ in range(2):
        params, ropt_state, rm = jstep(params, ropt_state, rbatch)
        model, topt_state, tm = tstep(model, topt_state, tbatch)
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(rm[key]),
                                                   rel=GN_RTOL)
    ref = _named(tc, ropt_state["err"])
    flips = total = 0
    for k, v in topt_state["err"].items():
        d, top = np.abs(_np(v) - ref[k]), float(np.abs(ref[k]).max())
        bar = 254 * GRAD_BAR * top
        flips += int((d > bar).sum())
        total += d.size
        assert float(d.max()) <= 2 * top + bar, k
    print(f"grad_compress: {flips} of {total} codes differ after 2 steps")
    assert flips <= 1e-3 * total
    for m, bar in (("mu", 1e-2), ("nu", 2e-2)):
        ref = _named(tc, ropt_state[m])
        for k, v in topt_state[m].items():
            assert _leaf_gap(_np(v), ref[k]) <= bar, (m, k)
    ref = _named(tc, params)
    for k, w in model.named_parameters():
        assert float(np.abs(_np(w) - ref[k]).max()) <= 2 * LR * 2, k


def test_mamba2_ln2_gets_a_zero_gradient_and_decays():
    """mamba2's FFN is "none", so nothing reads ``ln2``: its gradient is
    zeros, as ``jax.grad`` gives, not None, and AdamW's weight decay still
    applies to it (set to 1 here, so the decay shows)."""
    _, tc = _cfgs("mamba2-2.7b")
    model = convert.lm_params_from_arrays(
        tc, jax.tree.map(np.asarray, ref_init(_cfgs("mamba2-2.7b")[0],
                                              jax.random.key(0))),
        device="cpu")
    batch = synthetic_batch(tc, 0, S, B, device="cpu")
    grads, _ = ttrain.compute_grads(model, batch)
    ln2 = [k for k in grads if k.endswith(".ln2")]
    assert ln2 and all(torch.equal(grads[k], torch.zeros_like(grads[k]))
                       for k in ln2)
    with torch.no_grad():
        for k in ln2:
            model.get_parameter(k).fill_(1.0)
    _, ocfg = _opt_cfgs()
    model, _, _ = ttrain.make_train_step(tc, ocfg)(
        model, ttrain.init_train_state(tc, model), batch)
    want = np.float32(1.0) - np.float32(LR) * np.float32(ocfg.weight_decay)
    for k in ln2:
        np.testing.assert_allclose(_np(model.get_parameter(k)), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_loss_falls_over_8_steps_on_one_batch(name):
    """The reference's ``test_smoke_loss_decreases`` in the port: bf16,
    lr 1e-3 after one warmup step, 8 steps on one batch."""
    cfg = tcfg.get_config(name).reduced()
    model = convert.lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, ref_init(rcfg.get_config(name).reduced(),
                                               jax.random.key(0))),
        device="cpu")
    _, ocfg = _opt_cfgs()
    step = ttrain.make_train_step(cfg, ocfg)
    opt = ttrain.init_train_state(cfg, model)
    batch = synthetic_batch(cfg, 0, 32, 2, device="cpu")
    losses = []
    for _ in range(8):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the trainable model: aux, remat, the embedding, serving untouched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "minitron-4b",
                                  "qwen3-moe-235b-a22b"])
def test_forward_with_aux_matches_reference(name):
    """``forward(..., with_aux=True)``: the logits as without it, and the
    MoE load-balance losses summed in stack order (0 without MoE)."""
    rc, tc = _cfgs(name)
    params = ref_init(rc, jax.random.key(4))
    model = convert.lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                          device="cpu")
    toks = np.asarray(ref_batch(rc, 0, S, B)["tokens"])
    logits, aux = model(torch.from_numpy(toks), with_aux=True)
    rlogits, raux = ref_forward(rc, params, toks)
    assert torch.equal(logits, model(torch.from_numpy(toks)))
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) == pytest.approx(float(raux), rel=1e-6, abs=0)
    if not tc.n_experts:
        assert float(aux) == 0.0
    assert all(a.grad_fn is None and d.grad_fn is None
               for a, d in model.moe_stats())


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "hymba-1.5b",
                                  "whisper-large-v3"])
def test_remat_gives_the_same_gradients(name):
    """``remat=True`` (each pattern group and encoder layer recomputed in
    the backward) against ``remat=False``: the same loss and gradient
    bits, since the recomputation repeats the same operations."""
    _, tc = _cfgs(name)
    rc, _ = _cfgs(name)
    tree = jax.tree.map(np.asarray, ref_init(rc, jax.random.key(5)))
    batch = synthetic_batch(tc, 0, S, B, device="cpu")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        model = convert.lm_params_from_arrays(cfg, tree, device="cpu")
        out.append(ttrain.compute_grads(model, batch))
    (g0, m0), (g1, m1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_remat_checkpoints_only_while_training(monkeypatch):
    """Serving and a forward over frozen weights never checkpoint; a
    training step checkpoints each pattern group once (the prologue
    outside them)."""
    name = "deepseek-v2-lite-16b"  # one prologue layer, then groups
    _, tc = _cfgs(name, remat=True)
    rc, _ = _cfgs(name)
    model = convert.lm_params_from_arrays(
        tc, jax.tree.map(np.asarray, ref_init(rc, jax.random.key(6))),
        device="cpu")
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **k: calls.append(a[:2])
                        or real(fn, *a, **k))
    batch = synthetic_batch(tc, 0, S, B, device="cpu")
    model(batch["tokens"])
    assert calls == []
    ttrain.compute_grads(model, batch)
    n_pro, n_pat = len(tc.prologue), len(tc.pattern)
    assert calls == [(lo, lo + n_pat)
                     for lo in range(n_pro, tc.n_layers, n_pat)]


def test_embedding_backward_adds_repeated_tokens():
    """``embed``'s forward is the rows of the table; its backward adds a
    token's gradients into its row (tokens repeat in the batch)."""
    from repro_torch.models.layers import embed

    table = torch.randn(11, 4, requires_grad=True)
    tokens = torch.tensor([[1, 3, 1], [10, 3, 1]], dtype=torch.int32)
    out = embed(tokens, table)
    assert torch.equal(out, table.detach()[tokens.long()])
    w = torch.randn(2, 3, 4)
    (out * w).sum().backward()
    want = torch.zeros(11, 4).index_add_(0, tokens.reshape(-1).long(),
                                         w.reshape(-1, 4))
    assert torch.allclose(table.grad, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["hymba-1.5b", "llama-3.2-vision-90b",
                                  "minitron-4b"])
def test_serving_builds_no_autograd_graph(name):
    """``prefill``, ``decode_step`` and ``greedy_generate`` give logits and
    tokens without gradients, before and after a training step; the step
    leaves every weight frozen and without a ``.grad``."""
    cfg = tcfg.get_config(name).reduced()
    model = convert.lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, ref_init(rcfg.get_config(name).reduced(),
                                               jax.random.key(7))),
        device="cpu")
    batch = synthetic_batch(cfg, 0, 12, 2, device="cpu")
    media = batch.get("media")

    def serve():
        caches = make_caches(cfg, 2, 16, device="cpu")
        logits = prefill(model, batch["tokens"][:, :8], caches, media)
        assert not logits.requires_grad and logits.grad_fn is None
        logits = decode_step(model, caches, batch["tokens"][:, 8:9], 8)
        assert not logits.requires_grad and logits.grad_fn is None
        toks = greedy_generate(model, batch["tokens"][:, :8],
                               make_caches(cfg, 2, 16, device="cpu"), 3,
                               media=media)
        assert not toks.requires_grad
        assert not model(batch["tokens"], media).requires_grad

    serve()
    _, ocfg = _opt_cfgs()
    ttrain.make_train_step(cfg, ocfg)(model, ttrain.init_train_state(cfg, model),
                                      batch)
    assert all(not p.requires_grad and p.grad is None
               for p in model.parameters())
    serve()
