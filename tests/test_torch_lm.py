"""The port's LM configs, layers and attention against the JAX package's, on
the CPU: the same seeded inputs through both, in float32 (rtol 1e-5, atol
1e-6), and the configs field by field."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models.attention as ra
import repro.models.layers as rl
import repro_torch.configs as tcfg
import repro_torch.models.attention as ta
import repro_torch.models.layers as tl
from repro.data.tokens import synthetic_batch as ref_batch
from repro.models.transformer import init_params as ref_init
from repro_torch import convert
from repro_torch.data.tokens import synthetic_batch
from repro_torch.models.transformer import (
    Transformer, init_params, param_shapes,
)
from repro_torch.serving.cache import make_caches

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
#: every arch: all ten serve in the port
ALL_ARCHS = sorted(rcfg.ARCHS)
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(port: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _fields(cfg) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["dtype"] = DTYPES.get(d["dtype"], d["dtype"])
    for k in ("pattern", "prologue"):
        d[k] = tuple(dataclasses.astuple(s) for s in d[k])
    return d


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_names_the_same_archs():
    assert sorted(tcfg.ARCHS) == ALL_ARCHS
    assert tcfg.SHAPES == rcfg.SHAPES
    assert tcfg.LONG_CONTEXT_ARCHS == rcfg.LONG_CONTEXT_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("gpt-2")


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_config_equals_the_reference_field_by_field(name):
    ref, port = rcfg.get_config(name), tcfg.get_config(name)
    assert _fields(port) == _fields(ref)
    assert port.dtype is torch.bfloat16
    assert _fields(port.reduced()) == _fields(ref.reduced())
    assert _fields(port.with_groups(1)) == _fields(ref.with_groups(1))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_counts_equal(name):
    ref, port = rcfg.get_config(name), tcfg.get_config(name)
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()
    assert port.reduced().n_params() == ref.reduced().n_params()
    assert port.n_pattern_groups == ref.n_pattern_groups


def test_cell_supported_matrix_equal():
    for arch in ALL_ARCHS:
        for shape in rcfg.SHAPES:
            assert tcfg.cell_supported(arch, shape) == rcfg.cell_supported(
                arch, shape)


@pytest.mark.parametrize("name", ["gemma3-12b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_synthetic_batch_tokens_identical(name):
    ref = ref_batch(rcfg.get_config(name).reduced(), 3, 24, 2)
    port = synthetic_batch(tcfg.get_config(name).reduced(), 3, 24, 2,
                           device="cpu")
    for k in ("tokens", "labels"):
        assert port[k].dtype == torch.int32
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    assert ("media" in port) == ("media" in ref)
    if "media" in ref:  # bf16 from the same float32 draws: the same bits
        np.testing.assert_array_equal(
            port["media"].view(torch.int16).numpy(),
            np.asarray(ref["media"]).view(np.int16))


# ---------------------------------------------------------------------------
# layers, float32
# ---------------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    s = rng.standard_normal(64, dtype=np.float32) * 0.1
    _close(tl.rms_norm(_t(x), _t(s), 1e-6), rl.rms_norm(x, s, 1e-6))


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_to_position_2048(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2049, 3, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(2049, dtype=np.int32), (2, 2049))
    _close(tl.apply_rope(_t(x), _t(pos), theta), rl.apply_rope(x, pos, theta))
    np.testing.assert_array_equal(
        tl._freqs(16, theta, torch.device("cpu")).numpy(),
        np.asarray(jnp.asarray(rl.rope_freqs(16, theta), jnp.float32)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_ffn(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64), dtype=np.float32)
    w = [rng.standard_normal(s, dtype=np.float32) * 0.1
         for s in ((64, 128), (64, 128), (128, 64))]
    port = tl.swiglu_ffn(_t(x), *map(_t, w), getattr(tl, act))
    _close(port, rl.swiglu_ffn(x, *w, getattr(rl, act)))


def test_unembed():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64), dtype=np.float32)
    table = rng.standard_normal((256, 64), dtype=np.float32) * 0.02
    port = tl.unembed(_t(x), _t(table))
    assert port.dtype == torch.float32
    _close(port, rl.unembed(x, table))


# ---------------------------------------------------------------------------
# attention, float32
# ---------------------------------------------------------------------------

D, H, HKV, HD = 64, 4, 2, 16
KW = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, rope_theta=10000.0)


def _attn_inputs(seed, S, B=2):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s, dtype=np.float32) * 0.2
         for k, s in (("wq", (D, H * HD)), ("wk", (D, HKV * HD)),
                      ("wv", (D, HKV * HD)), ("wo", (H * HD, D)))}
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    return p, x


def _positions(S, B=2, start=0):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (B, S))


def _cache_map(k, pos):
    """{position: that position's keys} over the filled slots."""
    return {int(p): np.asarray(k)[:, i] for i, p in enumerate(np.asarray(pos))
            if p >= 0}


@pytest.mark.parametrize("window", [None, 4, 12])
def test_gqa_attention_train(window):
    p, x = _attn_inputs(4, 12)
    pos = _positions(12)
    port = ta.gqa_attention({k: _t(v) for k, v in p.items()}, _t(x), _t(pos),
                            window=window, **KW)
    ref, _ = ra.gqa_attention(p, x, jnp.asarray(pos), window=window, **KW)
    _close(port, ref)


@pytest.mark.parametrize("window,S", [(None, 12), (4, 12), (4, 3), (5, 12)])
def test_gqa_attention_prefill_then_decode(window, S):
    """Prefill's output and the positions its cache holds, then two decode
    steps. The reference's decode is held only where its prefill placed
    position p at slot p % Lc (S <= Lc or S % Lc == 0): window 5 over 12
    positions is the reference's ring fault, checked against its forward."""
    Lc = window or S + 2
    p, x = _attn_inputs(5, S + 2)
    tp = {k: _t(v) for k, v in p.items()}
    ref_cache = ra.make_gqa_cache(2, Lc, HKV, HD, jnp.float32)
    cache = ta.make_gqa_cache(2, Lc, HKV, HD, torch.float32, "cpu")
    pos = _positions(S)
    port = ta.gqa_attention(tp, _t(x[:, :S]), _t(pos), window=window,
                            cache=cache, **KW)
    ref, ref_cache = ra.gqa_attention(p, x[:, :S], jnp.asarray(pos),
                                      window=window, cache=ref_cache, **KW)
    _close(port, ref)
    ours, theirs = _cache_map(cache.k, cache.pos), _cache_map(ref_cache["k"],
                                                             ref_cache["pos"])
    assert sorted(ours) == sorted(theirs) == list(range(max(0, S - Lc), S))
    for q in ours:
        _close(torch.from_numpy(ours[q]), theirs[q])
    full, _ = ra.gqa_attention(p, x, jnp.asarray(_positions(S + 2)),
                               window=window, **KW)
    aligned = S <= Lc or S % Lc == 0
    for t in (S, S + 1):
        step = ta.gqa_attention(tp, _t(x[:, t:t + 1]), _t(_positions(1, start=t)),
                                window=window, cache=cache, pos=t, **KW)
        _close(step, np.asarray(full)[:, t:t + 1])
        ref, ref_cache = ra.gqa_attention(
            p, x[:, t:t + 1], jnp.asarray(_positions(1, start=t)),
            window=window, cache=ref_cache, **KW)
        if aligned:
            _close(step, ref)


# ---------------------------------------------------------------------------
# weights carried across, refusals, entry points
# ---------------------------------------------------------------------------

def _ref_tree(cfg, seed=0):
    return jax.tree.map(np.asarray, ref_init(cfg, jax.random.key(seed)))


def _ref_leaf(rc, tree, name: str) -> np.ndarray:
    """The reference's array behind a port weight's name: layer i of the
    stack is ``prologue[i]`` or ``groups[pi][...][g]``, encoder layer j
    ``encoder[...][j]``."""
    parts = name.split(".")
    if len(parts) == 1:
        return tree[name]
    n_pro, n_pat = len(rc.prologue), len(rc.pattern)
    i, path = int(parts[1]), parts[2:]
    if parts[0] == "encoder":
        node, at = tree["encoder"], i
    elif i < n_pro:
        node, at = tree["prologue"][i], None
    else:
        g, pi = divmod(i - n_pro, n_pat)
        node, at = tree["groups"][pi], g
    for p in path:
        node = node[p]
    return node if at is None else node[at]


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_lm_params_from_arrays_carries_bf16_bit_for_bit(name):
    """Every leaf of the reference's tree, bit for bit: bf16 ones through
    an int16 view, the float32 ones (router, A_log, dt_bias, D) as they
    are; no leaf is left over."""
    rcf = rcfg.get_config(name).reduced()
    tree = _ref_tree(rcf)
    model = convert.lm_params_from_arrays(tcfg.get_config(name).reduced(),
                                          tree, device="cpu")
    sd = model.state_dict()
    assert set(sd) == set(param_shapes(model.cfg))
    assert sum(t.numel() for t in sd.values()) == sum(
        a.size for a in jax.tree.leaves(tree))
    for k, t in sd.items():
        ref = np.asarray(_ref_leaf(rcf, tree, k))
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          ref.view(np.int16), err_msg=k)
        else:
            assert t.dtype == torch.float32 and ref.dtype == np.float32, k
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)


def test_lm_params_from_arrays_refuses_a_mismatched_tree():
    cfg = tcfg.get_config("gemma3-12b").reduced()
    tree = _ref_tree(rcfg.get_config("gemma3-12b").reduced())
    wide = dataclasses.replace(cfg, d_ff=256)
    with pytest.raises(ValueError, match="shapes"):
        convert.lm_params_from_arrays(wide, tree, device="cpu")
    deep = dataclasses.replace(cfg, n_layers=18)
    with pytest.raises(ValueError, match="groups"):
        convert.lm_params_from_arrays(deep, tree, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        convert.lm_params_from_arrays(
            dataclasses.replace(cfg, dtype=torch.float32), tree, device="cpu")
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_arrays(untied, tree, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.get_config("gemma3-12b").reduced()
    for call in (lambda: init_params(cfg, 0),
                 lambda: make_caches(cfg, 1, 16),
                 lambda: synthetic_batch(cfg, 0, 8, 1),
                 lambda: convert.lm_params_from_arrays(
                     cfg, _ref_tree(rcfg.get_config("gemma3-12b").reduced()))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_init_params_draws_the_reference_distribution():
    """Stds 0.02 and 0.02/sqrt(2 n_layers) for the output projections,
    truncated at 2 sigma, norms 0; the same seed gives the same weights."""
    cfg = dataclasses.replace(tcfg.get_config("minitron-4b").reduced(),
                              dtype=torch.float32)
    a, b = init_params(cfg, 7, "cpu"), init_params(cfg, 7, "cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    sd = a.state_dict()
    emb = sd["embed"]
    assert abs(float(emb.std()) - 0.02 * 0.8796) < 1e-3  # truncated at 2σ
    assert float(emb.abs().max()) <= 0.04
    wo = sd["layers.0.attn.wo"]
    assert float(wo.abs().max()) <= 2 * 0.02 / (2 * cfg.n_layers) ** 0.5
    assert not sd["layers.0.ln1"].any() and not sd["final_norm"].any()
    assert not torch.equal(init_params(cfg, 8, "cpu").embed, emb)
    assert all(not p.requires_grad for p in a.parameters())


def test_with_groups_one_is_one_pattern_group():
    cfg = tcfg.get_config("gemma3-12b").with_groups(1)
    assert cfg.n_layers == 6 and cfg.n_pattern_groups == 1
    shapes = param_shapes(cfg)
    assert shapes["layers.5.attn.wq"] == (3840, 16 * 256)
    assert shapes["embed"] == (262144, 3840) and "unembed" not in shapes
