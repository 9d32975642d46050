"""Serving with media, the port against the JAX package on the CPU at
reduced size, in float32: llama-3.2-vision-90b (cross layers over image
patch states) and whisper-large-v3 (a decoder cross-attending to its
encoder's states).

The reference's fault that the port does not copy: its prefill never
projects the media (``serving/cache.py`` makes the cross K/V caches as
zeros, and ``_apply_layer`` takes a present cache entry as projected), so
its prefill and decode do not change when the media do, and depart from its
own ``forward``. The port's prefill projects the media into those caches;
its prefill and decode change with the media and equal the JAX ``forward``
within 1e-4 of the largest |logit|. Also here: the media arguments' checks,
and the serving CLI for all ten archs.
"""

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
import repro.models.transformer as rt
import repro_torch.configs as tcfg
from repro.data.tokens import synthetic_batch as ref_batch
from repro.serving.cache import make_caches as ref_make_caches
from repro.serving.engine import decode_step as ref_decode
from repro.serving.engine import prefill as ref_prefill
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models.attention import cross_kv_project
from repro_torch.models.transformer import init_params
from repro_torch.serving.cache import make_caches
from repro_torch.serving.engine import decode_step, prefill

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEDIA_ARCHS = ["llama-3.2-vision-90b", "whisper-large-v3"]
F32_BAR = 1e-4  # of the largest |logit| of the JAX result
B, S, DEC = 2, 16, 4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _gap(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _run(name):
    """One prompt of S tokens then DEC - 1 decode steps, under the batch's
    media and under ``media * 3 + 1``: for each, the JAX ``forward`` over
    all S + DEC - 1 tokens, the JAX ``prefill`` and decode steps, and the
    port's; numpy float32 logits."""
    rc = dataclasses.replace(rcfg.get_config(name).reduced(), dtype=jnp.float32)
    tc = dataclasses.replace(tcfg.get_config(name).reduced(),
                             dtype=torch.float32)
    params = rt.init_params(rc, jax.random.key(1))
    model = lm_params_from_arrays(tc, jax.tree.map(np.asarray, params),
                                  device="cpu")
    batch = ref_batch(rc, 0, S + DEC - 1, B)
    toks = np.array(batch["tokens"])
    fwd = jax.jit(lambda p, t, m: rt.forward(rc, p, t, m)[0])
    jprefill = jax.jit(functools.partial(ref_prefill, rc))
    jstep = jax.jit(functools.partial(ref_decode, rc))
    out = {}
    for which, media in (("media", np.array(batch["media"])),
                         ("moved", np.array(batch["media"]) * 3 + 1)):
        r = dict(forward=np.asarray(fwd(params, toks, media)))
        caches = ref_make_caches(rc, B, max_len=S + DEC)
        lg, caches = jprefill(params, toks[:, :S], caches, media)
        jax_steps = [np.asarray(lg)]
        caches_t = make_caches(tc, B, S + DEC, device="cpu")
        port = [prefill(model, _t(toks[:, :S]), caches_t, _t(media)).numpy()]
        for t in range(S, S + DEC - 1):
            lg, caches = jstep(params, caches, toks[:, t:t + 1], jnp.int32(t))
            jax_steps.append(np.asarray(lg))
            port.append(decode_step(model, caches_t, _t(toks[:, t:t + 1]),
                                    t).numpy())
        r.update(jax=np.stack(jax_steps, 1), port=np.stack(port, 1),
                 caches=caches_t, media=media)
        out[which] = r
    return dict(runs=out, model=model, toks=toks, tc=tc)


def _at_steps(forward):
    """The forward's logits at the positions prefill and each decode step
    predict from: S - 1 onwards."""
    return forward[:, S - 1:]


@pytest.mark.parametrize("name", MEDIA_ARCHS)
def test_port_serving_equals_jax_forward_under_either_media(name):
    for which, r in _run(name)["runs"].items():
        gap = _gap(r["port"], _at_steps(r["forward"]))
        print(f"{name} {which}: the port's prefill and decode against JAX "
              f"forward {gap:.3g} of the largest |logit|")
        assert gap <= F32_BAR, (which, gap)


@pytest.mark.parametrize("name", MEDIA_ARCHS)
def test_port_serving_changes_with_the_media(name):
    runs = _run(name)["runs"]
    moved = _gap(runs["moved"]["port"], runs["media"]["port"])
    want = _gap(_at_steps(runs["moved"]["forward"]),
                _at_steps(runs["media"]["forward"]))
    print(f"{name}: the port's serving logits move {moved:.3g} of the "
          f"largest |logit| with the media (JAX forward's: {want:.3g})")
    assert moved > 100 * F32_BAR and want > 100 * F32_BAR


@pytest.mark.parametrize("name", MEDIA_ARCHS)
def test_reference_prefill_ignores_the_media_so_it_departs_from_its_forward(
        name):
    """The fault: the reference's prefill and decode give the same logits
    under either media (they attend to its zero caches), and so lie far
    from its own forward, by more than a hundred float32 bars."""
    runs = _run(name)["runs"]
    assert np.array_equal(runs["media"]["jax"], runs["moved"]["jax"])
    for which, r in runs.items():
        gap = _gap(r["jax"], _at_steps(r["forward"]))
        print(f"{name} {which}: the reference's prefill and decode against "
              f"its forward {gap:.3g} of the largest |logit|")
        assert gap > 100 * F32_BAR, (which, gap)


@pytest.mark.parametrize("name", MEDIA_ARCHS)
def test_prefill_fills_the_cross_caches_with_the_projected_media(name):
    r = _run(name)
    model, run = r["model"], r["runs"]["moved"]
    media = _t(run["media"])
    states = model.media_states(media)
    for layer, cache in zip(model.layers, run["caches"]):
        cross = cache.ekv if r["tc"].n_enc_layers else cache.xkv
        if cross is None:  # a VLM self-attention layer
            assert layer.spec.kind == "attn" and cache.kv is not None
            continue
        p = layer.xattn if r["tc"].n_enc_layers else layer.attn
        k, v = cross_kv_project(p, states.get("enc_states", states.get(
            "media_states")), n_kv_heads=r["tc"].n_kv_heads,
            head_dim=r["tc"].head_dim)
        assert cross.filled
        assert torch.equal(cross.k, k) and torch.equal(cross.v, v)


def test_decode_before_a_media_prefill_raises():
    for name in MEDIA_ARCHS:
        cfg = tcfg.get_config(name).reduced()
        model = init_params(cfg, 0, "cpu")
        caches = make_caches(cfg, B, 8, device="cpu")
        with pytest.raises(ValueError, match="prefill with media"):
            decode_step(model, caches, torch.zeros(B, 1, dtype=torch.int32), 0)


def test_media_arguments_are_checked():
    vlm = init_params(tcfg.get_config("llama-3.2-vision-90b").reduced(), 0,
                      "cpu")
    text = init_params(tcfg.get_config("gemma3-12b").reduced(), 0, "cpu")
    toks = torch.zeros(B, 4, dtype=torch.int32)
    media = torch.zeros(B, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs media"):
        vlm(toks)
    with pytest.raises(ValueError, match="needs media"):
        prefill(vlm, toks, make_caches(vlm.cfg, B, 8, device="cpu"))
    with pytest.raises(ValueError, match="reads no media"):
        text(toks, media)
    with pytest.raises(ValueError, match="the cache holds"):
        prefill(vlm, toks, make_caches(vlm.cfg, B, 8, n_media=12,
                                       device="cpu"), media)
    assert vlm(toks, media).shape == (B, 4, vlm.cfg.vocab)


@pytest.mark.parametrize("name", sorted(set(rcfg.ARCHS) - {"gemma3-12b"}))
def test_serve_cli_runs_every_arch_on_the_cpu(name):
    """Every arch but gemma3-12b (``tests/test_torch_serving.py`` runs
    that one): build, caches, media where the arch reads them, prefill,
    decode and greedy tokens through the CLI."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", name,
         "--reduced", "--batch", "2", "--prompt-len", "12", "--gen", "5",
         "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    max_len = 448 if name == "whisper-large-v3" else 17
    assert lines[0].startswith(f"[serve] {name}-smoke: cache ")
    assert lines[0].endswith(f"for B=2 L={max_len}")
    rest = lines[1:]
    if name in MEDIA_ARCHS:
        assert rest.pop(0) == "[serve] media (2, 16, 64)"
    assert "generated (2, 5)" in rest[0] and "no compile" in rest[0]
    assert rest[1].startswith("[serve] sample tokens: [")


def test_serve_cli_holds_whisper_to_its_448_positions():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "whisper-large-v3", "--reduced", "--prompt-len", "440", "--gen", "9",
         "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2
    assert "passes the decoder's 448 positions" in res.stderr
