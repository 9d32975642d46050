"""The port's cross-attention, MLA, MoE, Mamba2 and encoder against the JAX
package's, on the CPU at reduced size, module by module and then model by
model for the six archs that use them.

Bars: a module in float32 within rtol 1e-5 / atol 1e-6; a model's logits in
float32 within 1e-4 of the largest |logit| of the JAX result; in bf16 the
reference's own 0.25 absolute (``tests/test_models.py``), each test printing
the gap it measured.

What each model is held to. The attention-only, SSM, hybrid and cross archs:
``forward``, and ``prefill`` and each decode step against the JAX
``forward`` at the same positions (for the cross archs this is the port's
fixed path: the JAX ``prefill`` drops the media,
``tests/test_torch_serving_media.py``). The MoE archs, whose expert capacity
depends on the tokens of a call: ``prefill`` against the JAX ``forward`` over
the prompt alone (the same tokens), and each decode step against the JAX
``decode_step`` on its own caches, drop fractions included; decode against
``forward`` is printed, not held.
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
import repro.models.attention as ra
import repro.models.moe as rm
import repro.models.ssm as rs
import repro.models.transformer as rt
import repro_torch.configs as tcfg
import repro_torch.models.attention as ta
import repro_torch.models.moe as tm
import repro_torch.models.ssm as ts
from repro.data.tokens import synthetic_batch as ref_batch
from repro.serving.cache import make_caches as ref_make_caches
from repro.serving.engine import decode_step as ref_decode
from repro.serving.engine import prefill as ref_prefill
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models.transformer import init_params, param_shapes
from repro_torch.serving.cache import cache_bytes, make_caches
from repro_torch.serving.engine import decode_step, greedy_generate, prefill

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
F32_BAR = 1e-4  # of the largest |logit| of the JAX result
BF16_BAR = 0.25  # absolute, the reference's own (tests/test_models.py)
TIE = 1e-6  # a router's k-th and (k+1)-th probabilities this close: a tie
B, S, DEC = 2, 16, 4
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
DENSE = ["hymba-1.5b", "llama-3.2-vision-90b", "mamba2-2.7b",
         "whisper-large-v3"]
KINDS = sorted(MOE + DENSE)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(port: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _tp(p: dict) -> dict:
    return {k: _t(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# attention: cross, bidirectional, MLA (float32)
# ---------------------------------------------------------------------------

D, H, HKV, HD = 64, 4, 2, 16
KW = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, rope_theta=10000.0)


def _attn_p(rng, s=0.2):
    return {k: rng.standard_normal(sh, dtype=np.float32) * s
            for k, sh in (("wq", (D, H * HD)), ("wk", (D, HKV * HD)),
                          ("wv", (D, HKV * HD)), ("wo", (H * HD, D)))}


def _positions(S, B=2, start=0):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (B, S))


def test_cross_kv_project():
    rng = np.random.default_rng(10)
    p, media = _attn_p(rng), rng.standard_normal((2, 9, D), dtype=np.float32)
    port = ta.cross_kv_project(_tp(p), _t(media), n_kv_heads=HKV, head_dim=HD)
    ref = ra.cross_kv_project(p, media, n_kv_heads=HKV, head_dim=HD)
    for a, b in zip(port, ref):
        assert tuple(a.shape) == (2, 9, HKV, HD)
        _close(a, b)


@pytest.mark.parametrize("S,start", [(7, 0), (1, 11)])
def test_gqa_attention_cross(S, start):
    """Queries at positions start.. (RoPE on them only) over 9 media keys,
    all of them; S = 1 is a decode step's shape."""
    rng = np.random.default_rng(11)
    p = _attn_p(rng)
    x = rng.standard_normal((2, S, D), dtype=np.float32)
    media = rng.standard_normal((2, 9, D), dtype=np.float32)
    kv = ra.cross_kv_project(p, media, n_kv_heads=HKV, head_dim=HD)
    pos = _positions(S, start=start)
    port = ta.gqa_attention(_tp(p), _t(x), _t(pos),
                            cross_kv=tuple(map(_t, kv)), **KW)
    ref, cache = ra.gqa_attention(p, x, jnp.asarray(pos), cross_kv=kv, **KW)
    assert cache is None
    _close(port, ref)


def test_gqa_attention_bidirectional():
    """causal=False: every query reads every key (the encoder's form), and
    an early query's output changes when a later token does."""
    rng = np.random.default_rng(12)
    p, x = _attn_p(rng), rng.standard_normal((2, 10, D), dtype=np.float32)
    pos = _positions(10)
    port = ta.gqa_attention(_tp(p), _t(x), _t(pos), causal=False, **KW)
    ref, _ = ra.gqa_attention(p, x, jnp.asarray(pos), causal=False, **KW)
    _close(port, ref)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = ta.gqa_attention(_tp(p), _t(x2), _t(pos), causal=False, **KW)
    assert not torch.allclose(moved[:, 0], port[:, 0])


R, RD = 32, 8
MLA_KW = dict(n_heads=H, head_dim=HD, rope_dim=RD, rope_theta=10000.0)
#: the reference's mla_attention also takes the latent's rank
RMLA_KW = dict(MLA_KW, kv_lora=R)


def _mla_p(seed):
    """The reference's MLA weights for the reduced deepseek-v2-lite (d 64, 4
    heads of 16, latent 32, rope 8), in float32: its initializer's scale.
    At a std of 0.2 the logits grow sharp and outputs reach ~8, where the
    two packages' summation orders part by a few ulp, past atol 1e-6 where
    an output cancels to near zero."""
    rc = dataclasses.replace(rcfg.get_config("deepseek-v2-lite-16b").reduced(),
                             dtype=jnp.float32)
    return jax.tree.map(np.asarray, rt._init_mla(jax.random.key(seed), rc))


def test_mla_attention_train():
    rng = np.random.default_rng(13)
    p, x = _mla_p(13), rng.standard_normal((2, 12, D), dtype=np.float32)
    pos = _positions(12)
    port = ta.mla_attention(_tp(p), _t(x), _t(pos), **MLA_KW)
    ref, _ = ra.mla_attention(p, x, jnp.asarray(pos), **RMLA_KW)
    _close(port, ref)


def test_mla_attention_prefill_then_decode():
    """Prefill fills the latent cache (the same entries as the reference's),
    then three decode steps against the reference's decode and forward."""
    S, Lc = 9, 14
    rng = np.random.default_rng(14)
    p, x = _mla_p(14), rng.standard_normal((2, S + 3, D), dtype=np.float32)
    tp = _tp(p)
    cache = ta.make_mla_cache(2, Lc, R, RD, torch.float32, "cpu")
    ref_cache = ra.make_mla_cache(2, Lc, R, RD, jnp.float32)
    pos = _positions(S)
    port = ta.mla_attention(tp, _t(x[:, :S]), _t(pos), cache=cache, **MLA_KW)
    ref, ref_cache = ra.mla_attention(p, x[:, :S], jnp.asarray(pos),
                                      cache=ref_cache, **RMLA_KW)
    _close(port, ref)
    for name in ("c_kv", "k_rope", "pos"):
        _close(getattr(cache, name), ref_cache[name])
    full, _ = ra.mla_attention(p, x, jnp.asarray(_positions(S + 3)), **RMLA_KW)
    for t in range(S, S + 3):
        step = ta.mla_attention(tp, _t(x[:, t:t + 1]),
                                _t(_positions(1, start=t)), cache=cache,
                                pos=t, **MLA_KW)
        ref, ref_cache = ra.mla_attention(
            p, x[:, t:t + 1], jnp.asarray(_positions(1, start=t)),
            cache=ref_cache, **RMLA_KW)
        _close(step, ref)
        _close(step, np.asarray(full)[:, t:t + 1])


# ---------------------------------------------------------------------------
# MoE (float32)
# ---------------------------------------------------------------------------

E, K = 8, 2


def _moe_p(seed, shared):
    """The reference's MoE weights in float32 for a reduced config (8
    experts, top 2, width 32): qwen3-moe's without shared experts,
    deepseek-v2-lite's with 2."""
    name = "deepseek-v2-lite-16b" if shared else "qwen3-moe-235b-a22b"
    rc = dataclasses.replace(rcfg.get_config(name).reduced(),
                             dtype=jnp.float32)
    assert (rc.n_experts, rc.topk, rc.n_shared_experts) == (E, K, shared)
    return jax.tree.map(np.asarray, rt._init_ffn(
        jax.random.key(seed), rc, rc.pattern[0]))


def _dropped(frac, n: int) -> int:
    """The copies a drop fraction of ``n`` stands for (the two packages'
    float32 means of the same count may part by an ulp)."""
    return round(float(frac) * n)


def _margin(x, router, k) -> float:
    """The least gap between a token's k-th and (k+1)-th router
    probabilities (float32, as the reference computes them)."""
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x, jnp.float32).reshape(-1, router.shape[0])
        @ jnp.asarray(router, jnp.float32), axis=-1))
    s = -np.sort(-probs, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("T,cf", [((2, 1), 1.25), ((3, 7), 1.25),
                                  ((3, 7), 0.5)])
def test_moe_ffn(T, cf, shared):
    """y, aux and the drop fraction: at a decode step's T (capacity 1), at
    21 tokens, and at a capacity factor of 0.5, where 42 copies meet 24
    slots and at least 18 are dropped."""
    rng = np.random.default_rng(15 + shared)
    p, x = _moe_p(15, shared), rng.standard_normal((*T, D), dtype=np.float32)
    kw = dict(n_experts=E, topk=K, capacity_factor=cf, n_shared=shared)
    y, (aux, dropped), load = tm.moe_ffn(_tp(p), _t(x), **kw)
    ry, (raux, rdropped) = rm.moe_ffn(p, x, **kw)
    print(f"T={T} capacity factor {cf} shared={shared}: dropped "
          f"{float(dropped):.4f}, router's least k-th/(k+1)-th gap "
          f"{_margin(x, p['router'], K):.3g}")
    _close(y, ry)
    _close(aux, raux)
    n = T[0] * T[1] * K
    assert _dropped(dropped, n) == _dropped(rdropped, n)
    assert aux.dtype == dropped.dtype == torch.float32
    assert load.shape == (E,) and int(load.sum()) == n
    if cf == 0.5:
        assert _dropped(dropped, n) >= 18


def test_moe_route_breaks_ties_to_the_lower_expert_as_jax():
    probs_logits = np.log(np.array([[0.1, 0.3, 0.3, 0.3],
                                    [0.25, 0.25, 0.25, 0.25],
                                    [0.4, 0.1, 0.4, 0.1]], np.float32))
    _, gate, eidx = tm.route(_t(probs_logits), 2)
    ref_probs = jax.nn.softmax(jnp.asarray(probs_logits), axis=-1)
    ref_gate, ref_idx = jax.lax.top_k(ref_probs, 2)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(ref_idx))
    assert eidx.tolist() == [[1, 2], [0, 1], [0, 2]]
    _close(gate, ref_gate / ref_gate.sum(-1, keepdims=True))


def test_moe_combine_adds_each_tokens_copies_in_order():
    """The combine equals k adds in copy order from zero, bit for bit in
    bf16 (the order a scatter-add of the reference's layout takes)."""
    rng = np.random.default_rng(17)
    p = {k: _t(v).to(torch.bfloat16) if k != "router" else _t(v)
         for k, v in _moe_p(17, 0).items()}
    x = _t(rng.standard_normal((2, 5, D), dtype=np.float32)).to(torch.bfloat16)
    y, _, _ = tm.moe_ffn(p, x, n_experts=E, topk=K, capacity_factor=8.0)
    # no drops at this capacity: each copy is its expert's FFN of the token
    xt = x.reshape(-1, D)
    _, gate, eidx = tm.route(xt.float() @ p["router"], K)
    want = torch.zeros_like(xt)
    for j in range(K):
        e = eidx[:, j]
        h = tm.silu(torch.bmm(xt[:, None], p["w_gate"][e])) * torch.bmm(
            xt[:, None], p["w_up"][e])
        want = want + torch.bmm(h, p["w_down"][e])[:, 0] * gate[:, j, None].to(
            torch.bfloat16)
    assert torch.equal(y.reshape(-1, D), want)


# ---------------------------------------------------------------------------
# Mamba2 SSD (float32)
# ---------------------------------------------------------------------------

SH, SHD, SN = 3, 4, 5


def _ssd_inputs(seed, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, SH, SHD), dtype=np.float32),
            np.abs(rng.standard_normal((B, S, SH), dtype=np.float32)) * 0.5,
            -np.abs(rng.standard_normal(SH, dtype=np.float32)),
            rng.standard_normal((B, S, SN), dtype=np.float32),
            rng.standard_normal((B, S, SN), dtype=np.float32))


@pytest.mark.parametrize("S,chunk", [(12, 12), (20, 10), (32, 16), (16, 16)])
def test_ssd_scan(S, chunk):
    """pick_chunk with the reduced configs' ssm_chunk 16: 12 -> 12 and
    20 -> 10 (a proper divisor), 32 -> 16 (two chunks carried)."""
    assert ts.pick_chunk(S, 16) == rs.pick_chunk(S, 16) == chunk
    inp = _ssd_inputs(18, S)
    y, final = ts.ssd_scan(*map(_t, inp), chunk)
    ry, rfinal = rs.ssd_scan(*inp, chunk)
    _close(y, ry)
    _close(final, rfinal)


def test_ssd_decode_step():
    x, dt, A, Bm, Cm = _ssd_inputs(19, 1)
    state = np.random.default_rng(20).standard_normal((B, SH, SHD, SN),
                                                      dtype=np.float32)
    y, new = ts.ssd_decode_step(*map(_t, (state, x, dt, A, Bm, Cm)))
    ry, rnew = rs.ssd_decode_step(state, x, dt, A, Bm, Cm)
    _close(y, ry)
    _close(new, rnew)


def _f32(name):
    """(reference config, port config), reduced, in float32."""
    return (dataclasses.replace(rcfg.get_config(name).reduced(),
                                dtype=jnp.float32),
            dataclasses.replace(tcfg.get_config(name).reduced(),
                                dtype=torch.float32))


def test_mamba_block_prefill_then_decode():
    """A prefill of 12 tokens (its final state and conv tail in the cache),
    then three decode steps, against the reference's block and cache."""
    rc, tc = _f32("mamba2-2.7b")
    rng = np.random.default_rng(21)
    p = jax.tree.map(np.asarray, rt._init_ssm(jax.random.key(3), rc))
    p["A_log"] = rng.standard_normal(p["A_log"].shape).astype(np.float32) * 0.5
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape).astype(np.float32)
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(np.float32) * 0.1
    x = rng.standard_normal((B, 15, rc.d_model), dtype=np.float32)
    from repro.serving.cache import _ssm_cache

    cache, ref_cache = ts.make_ssm_cache(tc, B, "cpu"), _ssm_cache(rc, B)
    out = ts.mamba_block(_tp(p), _t(x[:, :12]), cfg=tc, cache=cache)
    ref, ref_cache = rs.mamba_block(p, x[:, :12], cfg=rc, cache=ref_cache)
    _close(out, ref)
    full, _ = rs.mamba_block(p, x, cfg=rc)
    for t in range(12, 15):
        _close(cache.state, ref_cache["state"])
        _close(cache.conv, ref_cache["conv"])
        step = ts.mamba_block(_tp(p), _t(x[:, t:t + 1]), cfg=tc, cache=cache)
        ref, ref_cache = rs.mamba_block(p, x[:, t:t + 1], cfg=rc,
                                        cache=ref_cache)
        _close(step, ref)
        _close(step, np.asarray(full)[:, t:t + 1])


def test_encoder_forward():
    """Whisper's bidirectional encoder over 16 frames, in float32."""
    rc, tc = _f32("whisper-large-v3")
    params = rt.init_params(rc, jax.random.key(4))
    model = lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                  device="cpu")
    media = np.random.default_rng(22).standard_normal(
        (B, rc.n_media_tokens, rc.d_model), dtype=np.float32)
    _close(model.encoder_forward(_t(media)),
           rt.encoder_forward(rc, params, media))


# ---------------------------------------------------------------------------
# models: the port against the JAX package, arch by arch
# ---------------------------------------------------------------------------

def _cfgs(name, dtype, window=None):
    rc, tc = (_f32(name) if dtype == "float32" else
              (rcfg.get_config(name).reduced(), tcfg.get_config(name).reduced()))
    if window:
        rc, tc = (dataclasses.replace(c, pattern=tuple(
            dataclasses.replace(s, window=window) if s.window else s
            for s in c.pattern)) for c in (rc, tc))
    return rc, tc


def _moe_log(log: list):
    """``moe_ffn`` for the reference's stack that appends each call's
    (dropped, router margin) to ``log``: run eagerly, unrolled."""
    real = rt.moe_ffn

    def wrapped(p, x, **kw):
        y, (aux, dropped) = real(p, x, **kw)
        log.append((float(dropped), _margin(x, p["router"], kw["topk"])))
        return y, (aux, dropped)

    return mock.patch.object(rt, "moe_ffn", wrapped)


@functools.lru_cache(maxsize=None)
def _run(name, dtype, S=S, dec=DEC + 1, window=None, seed=1):
    """Both packages over one prompt of S tokens (and the batch's media)
    then ``dec`` decode steps fed the batch's next tokens. The logits,
    numpy float32: the JAX ``forward`` over all S + dec tokens and over the
    prompt alone; the port's ``forward``, ``prefill`` and each decode step;
    for a MoE arch the JAX ``prefill`` and ``decode_step`` too (eager,
    unrolled) with each layer's drop fraction a call on both sides."""
    rc, tc = _cfgs(name, dtype, window)
    params = rt.init_params(rc, jax.random.key(seed))
    model = lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                  device="cpu")
    batch = ref_batch(rc, 0, S + dec, B)
    toks, media = np.array(batch["tokens"]), batch.get("media")
    tmedia = None if media is None else _t(np.asarray(media, np.float32)).to(
        tc.dtype)
    fwd = jax.jit(lambda p, t, m: rt.forward(rc, p, t, m)[0])
    out = dict(rc=rc, params=params, model=model, toks=toks, media=media,
               tmedia=tmedia, jax_forward=np.asarray(fwd(params, toks, media)),
               jax_prompt=np.asarray(fwd(params, toks[:, :S], media)))
    out["forward"] = model(_t(toks), tmedia).numpy()
    caches = make_caches(model.cfg, B, S + dec, device="cpu")
    steps = [prefill(model, _t(toks[:, :S]), caches, tmedia).numpy()]
    drops = [[float(d) for _, d in model.moe_stats()]]
    for t in range(S, S + dec - 1):
        steps.append(decode_step(model, caches, _t(toks[:, t:t + 1]), t).numpy())
        drops.append([float(d) for _, d in model.moe_stats()])
    out.update(steps=steps, drops=drops)
    if name in MOE:
        eager = dataclasses.replace(rc, scan_layers=False)
        rcaches = ref_make_caches(eager, B, max_len=S + dec)
        log, ref_steps, ref_drops = [], [], []
        with _moe_log(log):
            lg, rcaches = ref_prefill(eager, params, toks[:, :S], rcaches)
            ref_steps.append(np.asarray(lg))
            ref_drops.append(log[:])
            for t in range(S, S + dec - 1):
                log.clear()
                lg, rcaches = ref_decode(eager, params, rcaches,
                                         toks[:, t:t + 1], jnp.int32(t))
                ref_steps.append(np.asarray(lg))
                ref_drops.append(log[:])
            log.clear()
        out.update(jax_steps=ref_steps, jax_drops=ref_drops)
    return out


def _gap(port, ref) -> tuple[float, float]:
    """(max |port - ref|, max |ref|)."""
    return float(np.abs(port - ref).max()), float(np.abs(ref).max())


def _hold(what, pairs, dtype):
    for i, (p, q) in enumerate(pairs):
        err, top = _gap(p, q)
        bar = F32_BAR * top if dtype == "float32" else BF16_BAR
        print(f"{what} {i}: max |port - jax| {err:.3g} (bar {bar:.3g}, max "
              f"|logit| {top:.3g})")
        assert err <= bar, (what, i, err, bar)


def _serving_pairs(name, dtype):
    """(port, JAX) logits of prefill and each decode step: the JAX forward
    at the same positions, or for MoE the JAX prefill and decode_step."""
    r = _run(name, dtype)
    if name in MOE:
        return list(zip(r["steps"], r["jax_steps"]))
    return [(q, r["jax_forward"][:, S - 1 + i]) for i, q in enumerate(r["steps"])]


@pytest.mark.parametrize("name", KINDS)
def test_float32_forward_matches_jax(name):
    r = _run(name, "float32")
    _hold(f"{name} forward", [(r["forward"], r["jax_forward"])], "float32")


@pytest.mark.parametrize("name", DENSE)
def test_float32_prefill_and_decode_match_jax_forward(name):
    _hold(f"{name} serving", _serving_pairs(name, "float32"), "float32")


@pytest.mark.parametrize("name", MOE)
def test_moe_prefill_matches_jax_forward_over_the_prompt(name):
    """The same T: the prompt's tokens, in prefill and in forward."""
    r = _run(name, "float32")
    _hold(f"{name} prefill", [(r["steps"][0], r["jax_prompt"][:, -1])],
          "float32")


@pytest.mark.parametrize("name", MOE)
def test_moe_decode_matches_jax_decode_step_drops_included(name):
    """Each decode step against the JAX decode_step on its own caches, and
    every MoE layer's drop fraction equal, prefill included. Decode against
    forward is printed: the capacity of a B-token step drops copies."""
    r = _run(name, "float32")
    topk = r["rc"].topk
    for i, (ours, theirs) in enumerate(zip(r["drops"], r["jax_drops"])):
        n = B * (S if i == 0 else 1) * topk  # the call's copies
        near = [m for _, m in theirs if m < TIE]
        print(f"{name} call {i}: drop fractions {ours}, router's least "
              f"k-th/(k+1)-th gap {min(m for _, m in theirs):.3g}"
              + (f" (a near tie: {near})" if near else ""))
        assert [_dropped(d, n) for d in ours] == [
            _dropped(d, n) for d, _ in theirs], i
    assert any(d > 0 for step in r["drops"][1:] for d in step)
    _hold(f"{name} decode", list(zip(r["steps"], r["jax_steps"])), "float32")
    for i, q in enumerate(r["steps"][1:], 1):
        err, top = _gap(q, r["jax_forward"][:, S - 1 + i])
        print(f"{name} decode {i} against JAX forward (printed, not held): "
              f"{err:.3g} of max |logit| {top:.3g}")


@pytest.mark.parametrize("name", KINDS)
def test_float32_greedy_tokens_match_jax(name):
    """Greedy tokens equal the JAX oracle's wherever its top-two gap
    exceeds twice the float32 bar; a row is followed until its first token
    under that gap that differs. The oracle: JAX's forward over the prompt
    and the port's tokens (for MoE, JAX's prefill and decode loop, whose
    capacity is the port's)."""
    r = _run(name, "float32")
    rc, params, model = r["rc"], r["params"], r["model"]
    prompt, steps = r["toks"][:, :S], DEC + 1
    out = greedy_generate(model, _t(prompt),
                          make_caches(model.cfg, B, S + steps, device="cpu"),
                          steps, media=r["tmedia"]).numpy()
    assert out.shape == (B, steps) and out.dtype == np.int32
    if name in MOE:
        caches = ref_make_caches(rc, B, max_len=S + steps)
        lg, caches = jax.jit(functools.partial(ref_prefill, rc))(
            params, prompt, caches)
        step = jax.jit(functools.partial(ref_decode, rc))
    else:
        seq = np.concatenate([prompt, out[:, :-1]], 1)
        fwd = np.asarray(jax.jit(lambda p, t, m: rt.forward(rc, p, t, m)[0])(
            params, seq, r["media"]))
    live = np.ones(B, bool)
    for t in range(steps):
        lg = np.asarray(lg) if name in MOE else fwd[:, S - 1 + t]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * F32_BAR * np.abs(lg).max()
        tok = lg.argmax(-1).astype(np.int32)
        assert np.array_equal(out[live & sure, t], tok[live & sure]), t
        live &= out[:, t] == tok
        if name in MOE and t + 1 < steps:
            lg, caches = step(params, caches, tok[:, None], jnp.int32(S + t))
    assert live.any()


@pytest.mark.parametrize("S_ring", [8, 12, 13, 16])
def test_hymba_ring_decode_matches_jax_forward(S_ring):
    """Hymba's sliding windows set to 8: past the window, aligned or not,
    the port's prefill and six decode steps against the JAX forward at the
    same positions (attention ring and SSM state together)."""
    r = _run("hymba-1.5b", "float32", S=S_ring, dec=7, window=8)
    fwd = r["jax_forward"]
    _hold(f"hymba ring S={S_ring}",
          [(q, fwd[:, S_ring - 1 + i]) for i, q in enumerate(r["steps"])],
          "float32")


@pytest.mark.parametrize("what", ["forward", "serving"])
@pytest.mark.parametrize("name", KINDS)
def test_bf16_logits_within_the_reference_bar(name, what):
    r = _run(name, "bf16")
    pairs = ([(r["forward"], r["jax_forward"])] if what == "forward"
             else _serving_pairs(name, "bf16"))
    _hold(f"{name} bf16 {what}", pairs, "bf16")


# ---------------------------------------------------------------------------
# weights and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KINDS)
def test_lm_params_carry_every_leaf_with_its_dtype(name):
    """The float32 leaves (router, A_log, dt_bias, D) arrive as float32,
    every other as bf16 (``tests/test_torch_lm.py`` holds their bits);
    ``init_params`` makes the same names, shapes and dtypes, and the
    reference's constants (``mix_*`` 0.5, ``D`` 1, ``A_log``, ``dt_bias``,
    ``conv_b`` and the norms 0)."""
    rc = rcfg.get_config(name).reduced()
    tree = jax.tree.map(np.asarray, rt.init_params(rc, jax.random.key(0)))
    tc = tcfg.get_config(name).reduced()
    sd = lm_params_from_arrays(tc, tree, device="cpu").state_dict()
    for k, t in sd.items():
        want = torch.float32 if k.rsplit(".", 1)[-1] in (
            "router", "A_log", "dt_bias", "D") else torch.bfloat16
        assert t.dtype == want, k
    mine = init_params(tc, 0, "cpu").state_dict()
    assert set(mine) == set(param_shapes(tc)) == set(sd)
    for k, v in mine.items():
        assert (tuple(v.shape), v.dtype) == (tuple(sd[k].shape), sd[k].dtype), k
        if k.rsplit(".", 1)[-1] in ("mix_a", "mix_s", "D", "A_log", "dt_bias",
                                    "conv_b", "ln1", "ln2", "ln_x",
                                    "final_norm", "enc_final_norm"):
            assert torch.equal(v, sd[k]), k


def test_lm_params_from_arrays_refuses_a_float32_leaf_in_bf16():
    rc = rcfg.get_config("mamba2-2.7b").reduced()
    tree = jax.tree.map(np.asarray, rt.init_params(rc, jax.random.key(0)))
    tree["groups"][0]["ssm"]["conv_w"] = tree["groups"][0]["ssm"][
        "conv_w"].astype(np.float32)
    with pytest.raises(ValueError, match="conv_w is float32"):
        lm_params_from_arrays(tcfg.get_config("mamba2-2.7b").reduced(), tree,
                              device="cpu")
    tree = jax.tree.map(np.asarray, rt.init_params(rc, jax.random.key(0)))
    tree["groups"][0]["ssm"]["D"] = tree["groups"][0]["ssm"]["D"].astype(
        tree["embed"].dtype)
    with pytest.raises(ValueError, match="D is bfloat16"):
        lm_params_from_arrays(tcfg.get_config("mamba2-2.7b").reduced(), tree,
                              device="cpu")


def test_mla_cache_is_latent():
    """deepseek-v2-lite: the decode cache is the kv_lora latent and the
    shared rope key, not per-head K/V."""
    cfg = tcfg.get_config("deepseek-v2-lite-16b")
    caches = make_caches(cfg, B=1, max_len=1024, device="meta")
    kv = caches[1].kv
    assert isinstance(kv, ta.MLACache)
    assert kv.c_kv.shape == (1, 1024, cfg.mla_kv_lora)
    assert kv.k_rope.shape == (1, 1024, cfg.mla_rope_dim)
    mla_per_tok = kv.c_kv.shape[-1] + kv.k_rope.shape[-1]
    assert mla_per_tok < 2 * cfg.n_kv_heads * cfg.head_dim / 3


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_state_does_not_grow_with_max_len(name):
    cfg = tcfg.get_config(name)
    short, long = (make_caches(cfg, 2, L, device="meta") for L in (64, 65536))
    for a, b in zip(short, long):
        assert a.ssm.state.shape == b.ssm.state.shape == (
            2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        assert a.ssm.state.dtype == torch.float32
        assert a.ssm.conv.shape == (2, cfg.ssm_conv - 1,
                                    cfg.d_ssm_inner + 2 * cfg.ssm_state)
    if name == "mamba2-2.7b":  # attention-free: no cache grows at all
        assert cache_bytes(short) == cache_bytes(long)
