"""The port's serving path against the JAX package's, on the CPU, at reduced
size: the same weights (carried by ``lm_params_from_arrays``) and tokens
through ``forward``, ``prefill`` and ``decode_step`` of both.

Bars: in float32, logits within 1e-4 of the largest |logit| of the JAX
result; in bf16 the reference's own 0.25 absolute
(``tests/test_models.py``). The ring tests set gemma3's window to 8 and hold
the port's decode to the JAX ``forward`` after prompts that are and are not
multiples of the window; the JAX decode itself only where its prefill puts
position p at slot p % window (``ROADMAP.md``, known faults of the
reference)."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro_torch.configs as tcfg
from repro.data.tokens import synthetic_batch as ref_batch
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_params as ref_init
from repro.serving.cache import cache_bytes as ref_cache_bytes
from repro.serving.cache import make_caches as ref_make_caches
from repro.serving.engine import decode_step as ref_decode
from repro.serving.engine import prefill as ref_prefill
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve
from repro_torch.serving.cache import cache_bytes, make_caches
from repro_torch.serving.engine import decode_step, greedy_generate, prefill

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVED = ["command-r-plus-104b", "deepseek-67b", "gemma3-12b", "minitron-4b"]
F32_BAR = 1e-4  # of the largest |logit| of the JAX result
BF16_BAR = 0.25  # absolute, the reference's own (tests/test_models.py)
B, S, DEC = 2, 16, 4
RING_WINDOW, RING_DEC = 8, 6


def _cfgs(name, dtype=None, window=None):
    """(reference config, port config), reduced; float32 when asked; the
    sliding windows set to ``window`` when given."""
    out = []
    for reg, dt in ((rcfg, jnp.float32), (tcfg, torch.float32)):
        cfg = reg.get_config(name).reduced()
        if dtype == "float32":
            cfg = dataclasses.replace(cfg, dtype=dt)
        if window:
            cfg = dataclasses.replace(cfg, pattern=tuple(
                dataclasses.replace(s, window=window) if s.window else s
                for s in cfg.pattern))
        out.append(cfg)
    return out


def _run(name, dtype, S, dec, window=None, seed=1):
    """Both packages over one prompt of S tokens then ``dec`` decode steps
    fed the batch's next tokens: the logits of forward (over all S + dec
    tokens), prefill and each decode step, numpy float32."""
    rc, tc = _cfgs(name, dtype, window)
    params = ref_init(rc, jax.random.key(seed))
    model = lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                  device="cpu")
    toks = np.array(ref_batch(rc, 0, S + dec, B)["tokens"])
    ref, port = {}, {}
    ref["forward"] = np.asarray(jax.jit(
        lambda p, t: ref_forward(rc, p, t)[0])(params, toks))
    port["forward"] = model(torch.from_numpy(toks)).numpy()
    caches = ref_make_caches(rc, B, max_len=S + dec)
    lg, caches = jax.jit(functools.partial(ref_prefill, rc))(
        params, toks[:, :S], caches)
    ref["steps"] = [np.asarray(lg)]
    tcaches = make_caches(tc, B, S + dec, device="cpu")
    port["steps"] = [prefill(model, torch.from_numpy(toks[:, :S]),
                             tcaches).numpy()]
    step = jax.jit(functools.partial(ref_decode, rc))
    for t in range(S, S + dec - 1):
        lg, caches = step(params, caches, toks[:, t:t + 1], jnp.int32(t))
        ref["steps"].append(np.asarray(lg))
        port["steps"].append(decode_step(
            model, tcaches, torch.from_numpy(toks[:, t:t + 1]), t).numpy())
    return dict(ref=ref, port=port, rc=rc, params=params, model=model,
                toks=toks)


def _gap(port, ref) -> tuple[float, float]:
    """(max |port - ref|, max |ref|)."""
    return (float(np.abs(port - ref).max()), float(np.abs(ref).max()))


@functools.lru_cache(maxsize=None)
def _runs(name, dtype):
    return _run(name, dtype, S, DEC + 1)


def _check(name, dtype, what):
    r = _runs(name, dtype)
    ref, port = r["ref"], r["port"]
    if what == "forward":
        pairs = [(port["forward"], ref["forward"])]
    elif what == "prefill":
        pairs = [(port["steps"][0], ref["steps"][0])]
    else:  # each decode step
        pairs = list(zip(port["steps"][1:], ref["steps"][1:]))
        assert len(pairs) == DEC
    for i, (p, q) in enumerate(pairs):
        err, top = _gap(p, q)
        bar = F32_BAR * top if dtype == "float32" else BF16_BAR
        print(f"{name} {dtype} {what} {i}: max |port - jax| {err:.3g} "
              f"(bar {bar:.3g}, max |logit| {top:.3g})")
        assert err <= bar, (name, dtype, what, i, err, bar)


@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("name", SERVED)
def test_float32_logits_match_jax(name, what):
    _check(name, "float32", what)


@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("name", SERVED)
def test_bf16_logits_within_the_reference_bar(name, what):
    _check(name, "bf16", what)


@pytest.mark.parametrize("name", SERVED)
def test_float32_greedy_tokens_match_jax(name):
    """Greedy tokens equal the JAX loop's wherever its top-two gap exceeds
    twice the float32 bar; a row is followed until its first token under
    that gap that differs (past it the two feed different tokens)."""
    r = _runs(name, "float32")
    rc, params, model = r["rc"], r["params"], r["model"]
    prompt = r["toks"][:, :S]
    steps = DEC + 1
    out = greedy_generate(model, torch.from_numpy(prompt),
                          make_caches(model.cfg, B, S + steps, device="cpu"),
                          steps).numpy()
    assert out.shape == (B, steps) and out.dtype == np.int32
    caches = ref_make_caches(rc, B, max_len=S + steps)
    lg, caches = jax.jit(functools.partial(ref_prefill, rc))(
        params, prompt, caches)
    step = jax.jit(functools.partial(ref_decode, rc))
    live = np.ones(B, bool)
    for t in range(steps):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * F32_BAR * np.abs(lg).max()
        tok = lg.argmax(-1).astype(np.int32)
        assert np.array_equal(out[live & sure, t], tok[live & sure]), t
        live &= out[:, t] == tok
        if t + 1 < steps:
            lg, caches = step(params, caches, tok[:, None], jnp.int32(S + t))
    assert live.any()


# ---------------------------------------------------------------------------
# the ring: gemma3 with its window set to 8
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ring(S):
    return _run("gemma3-12b", "float32", S, RING_DEC + 1, window=RING_WINDOW)


def _ring_steps(S, side):
    r = _ring(S)
    fwd = r["ref"]["forward"]
    return [(q, fwd[:, S - 1 + i]) for i, q in enumerate(r[side]["steps"])]


@pytest.mark.parametrize("S", [8, 12, 13, 16])
def test_ring_decode_matches_jax_forward(S):
    """Past the window, aligned or not: the port's prefill and six decode
    steps against the JAX forward at the same positions."""
    for i, (q, f) in enumerate(_ring_steps(S, "port")):
        err, top = _gap(q, f)
        print(f"S={S} step {i}: max |port - jax forward| {err:.3g}")
        assert err <= F32_BAR * top, (S, i, err)


@pytest.mark.parametrize("S", [8, 16])
def test_ring_decode_matches_jax_decode_where_its_prefill_is_aligned(S):
    """S <= window or S % window == 0: the reference's prefill puts
    position p at slot p % window, so its decode is right and the two
    agree."""
    r = _ring(S)
    for i, (q, f) in enumerate(zip(r["port"]["steps"], r["ref"]["steps"])):
        err, top = _gap(q, f)
        assert err <= F32_BAR * top, (S, i, err)


@pytest.mark.parametrize("S", [12, 13])
def test_reference_decode_leaves_forward_after_an_unaligned_prefill(S):
    """The fault the port does not copy: after a prompt past the window
    and not a multiple of it, the reference's decode departs from its own
    forward by far more than the float32 bar."""
    worst = max(_gap(q, f)[0] / _gap(q, f)[1] for q, f in _ring_steps(S, "ref")[1:])
    print(f"S={S}: the reference's decode off its forward by {worst:.3g} "
          "of the largest |logit|")
    assert worst > 100 * F32_BAR


def test_sliding_window_cache_is_ring_buffer():
    """gemma3 local layers: cache length == window regardless of context
    (the port's caches are one a layer, in stack order)."""
    cfg = tcfg.get_config("gemma3-12b").reduced()
    caches = make_caches(cfg, B=1, max_len=4096, device="cpu")
    assert len(caches) == cfg.n_layers
    for i, spec in enumerate(cfg.pattern * cfg.n_pattern_groups):
        Lc = spec.window or 4096
        kv = caches[i].kv
        assert kv.k.shape == (1, Lc, cfg.n_kv_heads, cfg.head_dim)
        assert kv.pos.shape == (Lc,) and bool((kv.pos == -1).all())
        assert caches[i].ssm is caches[i].xkv is caches[i].ekv is None
    assert caches[0].kv.k.shape[1] == cfg.pattern[0].window
    assert caches[5].kv.k.shape[1] == 4096


@pytest.mark.parametrize("name", sorted(rcfg.ARCHS))
def test_cache_bytes_equal_the_reference(name):
    for reduced in (True, False):
        rc, tc = rcfg.get_config(name), tcfg.get_config(name)
        if reduced:
            rc, tc = rc.reduced(), tc.reduced()
            got = cache_bytes(make_caches(tc, 3, 40, device="cpu"))
        else:  # full width on the meta device: shapes only
            got = cache_bytes(make_caches(tc, 4, 1132, device="meta"))
        want = ref_cache_bytes(jax.eval_shape(
            lambda: ref_make_caches(rc, 3 if reduced else 4,
                                    40 if reduced else 1132)))
        assert got == want, (name, reduced)


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-12b", "--reduced", "--batch", "2", "--prompt-len", "12",
         "--gen", "5", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("[serve] gemma3-12b-smoke: cache ")
    assert "generated (2, 5)" in lines[1] and "no compile" in lines[1]
    assert lines[2].startswith("[serve] sample tokens: [")


def test_serve_cli_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma3-12b", "--reduced"])
