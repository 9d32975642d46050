"""The port's LM serving on a (data, model) process mesh under the
reference's ``serve`` specs (``launch/lm_mesh.py::run_serve_mesh``: gloo
ranks on the CPU, one a process; ``param_specs(mode="serve")`` and
``cache_specs_tree``) for every layer kind: GQA with windowed rings
(gemma3-12b), MLA with MoE and shared experts (deepseek-v2-lite-16b), Mamba2
(mamba2-2.7b), Hymba's hybrid layers, Whisper's encoder and decoder
cross-attention, the VLM's cross layers and qwen3-moe, all reduced (d 64, 4
heads), the sliding windows set to 8 as tests/test_torch_serving.py sets
gemma3's.

One spawn a mesh shape runs every case of that shape (a module fixture).
The weights are tests/test_torch_lm_mesh_kinds.py's (numpy seed 0, its
``OVERRIDES``: the MoE archs route with a capacity factor of 1.0, Hymba's
vocab is 255 and Whisper's 250, which a 'model' axis of 4 does not divide).
B = 4 requests, 2 a data rank; a prompt of 16 tokens (twice the window),
caches of 24 positions (which 'model' divides), 7 tokens a request: the
prefill and 6 decode steps.

Bars. Float32 against the port's one process: every step's logits within
1e-5 of its largest |logit|, the greedy tokens and each call's MoE drops
equal. Float32 against the JAX package's ``prefill``/``decode_step`` on one
device, fed the mesh's tokens, within 1e-4 (tests/test_torch_serving.py's
``F32_BAR``) where the reference's faults do not show (no media; the
prompt a multiple of the window). bf16 against the JAX package's sharded
serve (``jax.jit`` under the ``serve`` specs, 8 host devices,
``axis_types=Auto``, in a subprocess started with the module fixture), fed
the same tokens: within 0.25 (``BF16_BAR``, the reference's own).
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

from repro.serving.cache import make_caches as ref_make_caches
from repro.serving.engine import decode_step as ref_decode
from repro.serving.engine import prefill as ref_prefill
from repro_torch import convert
from repro_torch.data.tokens import synthetic_batch
from repro_torch.launch import lm_mesh
from repro_torch.launch.dryrun import cell_arguments, run_cell, sharded_bytes
from repro_torch.launch.mesh import MeshFailed
from repro_torch.models.transformer import Transformer, param_shapes
from repro_torch.serving.cache import cache_leaves, make_caches
from repro_torch.serving.engine import decode_step, prefill
from test_torch_lm_mesh_kinds import OVERRIDES, SRC, cfgs, named, port_params

torch.set_num_threads(1)

ARCHS = ("gemma3-12b", "deepseek-v2-lite-16b", "mamba2-2.7b", "hymba-1.5b",
         "whisper-large-v3", "llama-3.2-vision-90b", "qwen3-moe-235b-a22b")
#: where the reference's serving is held to: no media (its cross caches
#: stay zeros)
PLAIN = tuple(a for a in ARCHS if a not in ("whisper-large-v3",
                                            "llama-3.2-vision-90b"))
SHAPES = ((2, 4), (2, 2))
B, S, STEPS, CACHE = 4, 16, 7, 24
WINDOW = 8
#: the ring case: a prompt past the window and not a multiple of it, so
#: its slots and the decode's wrap across the 'model' ranks; and caches of
#: 23 positions, which no 'model' axis here divides (they run whole)
RING_S, ODD_CACHE = 12, 23
MESH_BAR = 1e-5  # float32 against the port's one process
F32_BAR = 1e-4  # float32 against the JAX package
BF16_BAR = 0.25  # bf16 against the JAX package's sharded serve
TIMEOUT = 300.0


def _cfgs(arch, dtype="f32"):
    """(reference config, port config): ``cfgs``' with the windows 8."""
    out = []
    for cfg in cfgs(arch, dtype):
        out.append(dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(s, window=WINDOW) if s.window else s
            for s in cfg.pattern)))
    return out


@functools.lru_cache(maxsize=None)
def _inputs(arch, S=S):
    """The prompt tokens (B, S + STEPS) (the decode's fed tokens after the
    prompt) and the media of ``synthetic_batch``, float32."""
    _, tc = _cfgs(arch)
    batch = synthetic_batch(tc, 0, S + STEPS, B, device="cpu")
    return batch["tokens"].to(torch.int32), batch.get("media")


def _case(arch, dtype="f32", S=S, cache_len=CACHE, fed=False, **kw):
    _, tc = _cfgs(arch, dtype)
    toks, media = _inputs(arch, S)
    if media is not None and dtype == "bf16":
        media = media.to(tc.dtype)
    return lm_mesh.ServeCase(
        tc, port_params(arch, dtype), toks[:, :S], STEPS, media,
        cache_len=cache_len, feed=toks[:, S:S + STEPS - 1] if fed else None,
        **kw)


#: the cases of each spawn, by name
CASES = {
    **{a: dict(arch=a, repeats=2) for a in ARCHS},
    # the rings wrap across ranks; gemma3's global layer and deepseek's MLA
    # caches run whole
    "gemma3-ring": dict(arch="gemma3-12b", S=RING_S, cache_len=ODD_CACHE),
    "hymba-ring": dict(arch="hymba-1.5b", S=RING_S),
    "deepseek-whole": dict(arch="deepseek-v2-lite-16b",
                           cache_len=ODD_CACHE),
    **{f"{a}-bf16": dict(arch=a, dtype="bf16", fed=True) for a in PLAIN},
}


_SHARDED = """
    import dataclasses, functools, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    import repro.configs as rcfg
    import repro_torch.configs as tcfg
    from repro_torch import convert
    from repro_torch.models.transformer import FLOAT32_LEAVES
    from repro.models import sharding as shd
    from repro.launch.mesh import (batch_specs_tree, cache_specs_tree,
                                   param_specs, to_shardings)
    from repro.serving.cache import make_caches
    from repro.serving.engine import decode_step, prefill

    d, shape = sys.argv[1], tuple(json.loads(sys.argv[2]))
    with open(d + 'cases.json') as fh:
        cases = json.load(fh)
    S, steps, L, window = (cases[k] for k in ('S', 'steps', 'L', 'window'))
    key = 'x'.join(map(str, shape))
    mesh = jax.make_mesh(shape, ('data', 'model'),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])

    def reduced(reg, arch, over):
        cfg = dataclasses.replace(reg.get_config(arch).reduced(), **over)
        return dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(s, window=window) if s.window else s
            for s in cfg.pattern))

    for arch, over in cases['archs'].items():
        cfg, tc = reduced(rcfg, arch, over), reduced(tcfg, arch, over)
        with np.load(d + arch + '.npz') as z:
            tree = convert.lm_tree_from_named(tc, {k: z[k] for k in z.files})
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(a, jnp.float32 if path[-1].key in
                                        FLOAT32_LEAVES else cfg.dtype), tree)
        toks = np.load(d + arch + '-tokens.npy')
        B = toks.shape[0]
        caches = make_caches(cfg, B, L)
        ps = param_specs(params, mesh, mode='serve')
        cs = cache_specs_tree(caches, mesh)
        out_sh = to_shardings((batch_specs_tree(jax.ShapeDtypeStruct(
            (B, cfg.vocab), jnp.float32), mesh), cs), mesh)
        with mesh, shd.rules(batch='data', model='model', mesh=mesh):
            pf = jax.jit(functools.partial(prefill, cfg),
                         in_shardings=to_shardings(
                             (ps, batch_specs_tree(toks[:, :S], mesh), cs),
                             mesh), out_shardings=out_sh)
            lg, caches = pf(params, toks[:, :S], caches)
            out = [np.asarray(lg)]
            dec = jax.jit(functools.partial(decode_step, cfg),
                          in_shardings=to_shardings(
                              (ps, cs, batch_specs_tree(toks[:, :1], mesh),
                               P()), mesh), out_shardings=out_sh)
            for t in range(S, S + steps - 1):
                lg, caches = dec(params, caches, toks[:, t:t + 1],
                                 jnp.int32(t))
                out.append(np.asarray(lg))
        np.save(d + arch + '-' + key + '.npy', np.stack(out, 1))
        print(arch, key, flush=True)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """Starts the reference's sharded bf16 serving, one subprocess a mesh
    shape, fed the cases' tokens; returns ``get(shape) -> {arch: logits (B,
    STEPS, vocab)}``, waiting for it."""
    d = tmp_path_factory.mktemp("jax-serve")
    for arch in PLAIN:
        np.savez(d / f"{arch}.npz", **named(arch, "bf16"))
        np.save(d / f"{arch}-tokens.npy", _inputs(arch)[0].numpy())
    with open(d / "cases.json", "w") as fh:
        json.dump(dict(S=S, steps=STEPS, L=CACHE, window=WINDOW,
                       archs={a: OVERRIDES.get(a, {}) for a in PLAIN}), fh)
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
            done[shape] = {a: np.load(d / f"{a}-{key}.npy") for a in PLAIN}
        return done[shape]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def runs(jax_sharded):
    """mesh shape -> {case name: ServeResult}, one spawn a shape (the
    reference's subprocesses already started)."""
    done = {}

    def get(shape):
        if shape not in done:
            run = lm_mesh.run_lm_mesh_cases(
                [_case(**kw) for kw in CASES.values()], shape, device="cpu",
                timeout=TIMEOUT)
            done[shape] = dict(zip(CASES, run.results))
        return done[shape]
    return get


def _model(arch) -> Transformer:
    _, tc = _cfgs(arch)
    return Transformer(tc, port_params(arch))


def _one_process(arch, tokens, S=S, cache_len=CACHE):
    """The port's one-process serving of the case, fed the mesh's
    ``tokens`` (B, STEPS): each step's logits and each call's MoE drops."""
    model = _model(arch)
    toks, media = _inputs(arch, S)
    caches = make_caches(model.cfg, B, cache_len,
                         None if media is None else media.shape[1],
                         device="cpu")
    logits = [prefill(model, toks[:, :S], caches, media)]
    drops = [model.moe_dropped()]
    for i in range(STEPS - 1):
        logits.append(decode_step(model, caches, tokens[:, i:i + 1], S + i))
        drops.append(model.moe_dropped())
    return torch.stack(logits, 1), drops


def _gap(got, want) -> tuple[float, float]:
    """(max |got - want| over the largest |want|, the largest |want|) of
    each step, the worst."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    worst = top = 0.0
    for i in range(want.shape[1]):
        t = float(np.abs(want[:, i]).max())
        g = float(np.abs(got[:, i] - want[:, i]).max()) / t
        if g >= worst:
            worst, top = g, t
    return worst, top


# ---------------------------------------------------------------------------
# (i) the mesh against the port's one process, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [a for a in ARCHS] + ["gemma3-ring",
                                                       "hymba-ring",
                                                       "deepseek-whole"])
@pytest.mark.parametrize("shape", SHAPES)
def test_serving_matches_one_process(runs, shape, name):
    """Prefill and every decode step within 1e-5 of one process's largest
    |logit|, the same greedy tokens (one process fed the mesh's, and its
    argmax each step the mesh's token) and each call's MoE drops equal."""
    kw = CASES[name]
    res = runs(shape)[name]
    arch = kw["arch"]
    logits, drops = _one_process(arch, res.tokens, kw.get("S", S),
                                 kw.get("cache_len", CACHE))
    gap, top = _gap(res.logits, logits)
    print(f"{shape} {name}: worst step max |mesh - one process| {gap:.3g} "
          f"of its max |logit| {top:.3g} (bar {MESH_BAR:g}); drops "
          f"{res.dropped}")
    assert res.logits.shape == (B, STEPS, logits.shape[-1])
    assert gap <= MESH_BAR
    assert torch.equal(res.tokens, logits.argmax(-1).to(torch.int32))
    assert res.dropped == drops


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_two_runs_give_the_same_bits(runs, shape, arch):
    res = runs(shape)[arch]
    assert all(r["repeats"] == [{"differ": False}] for r in res.ranks)


def test_moe_decode_drops_copies(runs):
    """The MoE cases drop copies at decode (a step's capacity is that of 4
    tokens), so the drops held equal above are not all zeros."""
    for name in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"):
        drops = runs((2, 4))[name].dropped
        assert any(sum(step) for step in drops[1:]), (name, drops)


# ---------------------------------------------------------------------------
# (ii) against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_single(arch, tokens: bytes):
    """The reference's one-device float32 serving of the case, fed the
    mesh's tokens (B, STEPS) given as bytes: each step's logits."""
    rc, tc = _cfgs(arch)
    params = jax.tree.map(lambda a: jnp.asarray(
        a, jnp.float32), convert.lm_tree_from_named(tc, named(arch)))
    toks = _inputs(arch)[0].numpy()
    fed = np.frombuffer(tokens, np.int32).reshape(B, STEPS)
    caches = ref_make_caches(rc, B, CACHE)
    lg, caches = jax.jit(functools.partial(ref_prefill, rc))(
        params, toks[:, :S], caches)
    out = [np.asarray(lg)]
    step = jax.jit(functools.partial(ref_decode, rc))
    for i in range(STEPS - 1):
        lg, caches = step(params, caches, fed[:, i:i + 1], jnp.int32(S + i))
        out.append(np.asarray(lg))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", PLAIN)
@pytest.mark.parametrize("shape", SHAPES)
def test_float32_matches_the_jax_package(runs, shape, arch):
    res = runs(shape)[arch]
    ref = _jax_single(arch, res.tokens.numpy().tobytes())
    gap, top = _gap(res.logits, ref)
    print(f"{shape} {arch} float32: worst step max |mesh - jax| {gap:.3g} "
          f"of its max |logit| {top:.3g} (bar {F32_BAR:g})")
    assert gap <= F32_BAR


@pytest.mark.parametrize("arch", PLAIN)
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_the_jax_sharded_serve(runs, jax_sharded, shape, arch):
    res = runs(shape)[f"{arch}-bf16"]
    ref = jax_sharded(shape)[arch]
    gaps = [float(np.abs(res.logits[:, i].numpy() - ref[:, i]).max())
            for i in range(STEPS)]
    print(f"{shape} {arch} bf16: max |mesh - jax sharded| a step {gaps} "
          f"(bar {BF16_BAR:g})")
    assert np.isfinite(res.logits.numpy()).all()
    assert max(gaps) <= BF16_BAR


# ---------------------------------------------------------------------------
# (iii) what each rank holds
# ---------------------------------------------------------------------------

def _info(arch, kind, S=S, cache_len=CACHE) -> dict:
    _, tc = _cfgs(arch)
    media = _inputs(arch, S)[1]
    frames = tc.family == "audio"
    info = dict(kind=kind, global_batch=B, cache_len=cache_len,
                seq_len=media.shape[1] if frames else S)
    if media is not None:
        info["media_len"] = media.shape[1]
    return info


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", SHAPES)
def test_each_rank_holds_its_shards(runs, shape, name):
    """Each rank's weights and cache leaves have the shapes of
    ``shard_index`` under their ``serve`` specs (no rank holds a whole cache
    its spec splits, no weight gathered for storage), and its resident bytes
    are the dry run's ``argument_bytes`` of the decode and of the prefill
    cell, ``run_cell(..., param_mode="serve")`` (Whisper's prefill with
    its prompt's tokens, where the reference's holds 448)."""
    kw = CASES[name]
    arch, Sc = kw["arch"], kw.get("S", S)
    L = kw.get("cache_len", CACHE)
    res = runs(shape)[name]
    _, tc = _cfgs(arch, kw.get("dtype", "f32"))
    mesh = lm_mesh.abstract_mesh(shape)
    specs = lm_mesh.param_specs(tc, mesh, "serve")
    full = param_shapes(tc)
    media = _inputs(arch, Sc)[1]
    caches = make_caches(tc, B, L, None if media is None else media.shape[1],
                         device="meta")
    cspecs = lm_mesh.cache_specs_tree(caches, mesh)
    cshape = {k: t.shape for k, t in cache_leaves(caches)}
    for r, rank in enumerate(res.ranks):
        for k, shp in {**full, **cshape}.items():
            spec = specs.get(k) or cspecs[k]
            idx = lm_mesh.shard_index(spec, shp, mesh, r)
            assert rank["shards"][k] == [s.stop - s.start for s in idx], \
                (r, k)
        held = rank["resident_bytes"]
        for kind in ("decode", "prefill"):
            info = _info(arch, kind, Sc, L)
            cell = run_cell(arch, kind, cfg=tc, mesh_shape=shape,
                            shape_info=info, param_mode="serve")
            want = cell["argument_bytes"]
            if kind == "prefill" and tc.family == "audio":
                args = cell_arguments(tc, info, mesh, "serve")
                want += B * Sc * 4 // shape[0] - sharded_bytes(
                    args["tokens"], mesh)
            got = held["params"] + held["caches"] + held[f"{kind}_inputs"]
            assert got == want, (r, kind, held, want)


def test_split_and_whole_caches(runs):
    """At (2, 4) the 24-slot and 8-slot rings, the latent cache and the
    cross caches are split by slots or frames, the SSM state by heads and
    the conv tail by channels; gemma3's 23-slot global ring and deepseek's
    23-slot latent cache are whole on each rank."""
    res = runs((2, 4))
    assert res["gemma3-12b"].ranks[0]["shards"]["layers.0.kv.k"] == \
        [2, 2, 2, 16]  # a window of 8 over 4 ranks, every KV head
    assert res["gemma3-12b"].ranks[0]["shards"]["layers.5.kv.k"] == \
        [2, 6, 2, 16]
    assert res["gemma3-ring"].ranks[0]["shards"]["layers.5.kv.k"] == \
        [2, 23, 2, 16]
    assert res["deepseek-v2-lite-16b"].ranks[0]["shards"][
        "layers.0.kv.c_kv"] == [2, 6, 32]
    assert res["deepseek-whole"].ranks[0]["shards"]["layers.0.kv.c_kv"] == \
        [2, 23, 32]
    mamba = res["mamba2-2.7b"].ranks[0]["shards"]
    assert mamba["layers.0.ssm.state"] == [2, 2, 16, 16]
    assert mamba["layers.0.ssm.conv"] == [2, 3, 40]
    assert res["whisper-large-v3"].ranks[0]["shards"]["layers.0.ekv.k"] == \
        [2, 4, 2, 16]


def test_serve_specs_leave_dense_weights_whole_over_data():
    """Under ``serve`` no weight but an expert bank names 'data', and the
    model gathers none for storage (``lm_mesh.fsdp_axes``)."""
    for arch in ARCHS:
        _, tc = _cfgs(arch)
        specs = lm_mesh.param_specs(tc, lm_mesh.abstract_mesh((2, 4)),
                                    "serve")
        for k, spec in specs.items():
            if "data" in spec:
                assert k.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down")
                assert len(spec) == 3, k
    assert lm_mesh.fsdp_axes("serve") == ()
    assert lm_mesh.fsdp_axes("train") == ("data",)


# ---------------------------------------------------------------------------
# (iv) refusals and the import pin
# ---------------------------------------------------------------------------

def test_serve_refusals():
    _, tc = _cfgs("gemma3-12b")
    toks, _ = _inputs("gemma3-12b")
    params = port_params("gemma3-12b")
    with pytest.raises(ValueError, match="does not divide over 'data'"):
        lm_mesh.run_serve_mesh(tc, params, toks[:3, :S], (2, 1), 2,
                               device="cpu")
    with pytest.raises(ValueError, match="pass a cache"):
        lm_mesh.run_serve_mesh(tc, params, toks[:, :S], (1, 2), 4,
                               device="cpu", cache_len=S + 2)
    with pytest.raises(ValueError, match="at least 1"):
        lm_mesh.run_serve_mesh(tc, params, toks[:, :S], (1, 2), 0,
                               device="cpu")
    with pytest.raises(ValueError, match="feed"):
        lm_mesh.run_serve_mesh(tc, params, toks[:, :S], (1, 2), 3,
                               device="cpu", feed=toks[:, :1])
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        lm_mesh.run_serve_mesh(tc, params, toks[:, :S], (1, 2), 2,
                               device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'train' or 'serve'"):
        lm_mesh.param_specs(tc, lm_mesh.abstract_mesh((2, 2)), "decode")
    with pytest.raises(ValueError, match="'train' or 'serve'"):
        Transformer(tc, params, mode="decode")


def test_a_failing_serving_rank_fails_the_run():
    """A serving rank that raises (every rank: 3 query heads on a 'model'
    axis of 2, ``check_grid``'s refusal under the serve specs too) fails
    the run with its log; nothing falls back to one process."""
    _, tc = _cfgs("gemma3-12b")
    cfg = dataclasses.replace(tc, n_heads=3, n_kv_heads=1)
    arrays = {k: torch.zeros(s, dtype=cfg.dtype)
              for k, s in param_shapes(cfg).items()}
    with pytest.raises(MeshFailed, match="splits a query head"):
        lm_mesh.run_serve_mesh(cfg, arrays, _inputs("gemma3-12b")[0][:, :S],
                               (1, 2), 2, device="cpu", timeout=TIMEOUT)


def test_serving_modules_import_neither_jax_nor_repro():
    code = (
        "import sys, torch.distributed as dist\n"
        "import repro_torch.launch.lm_mesh, repro_torch.serving.engine\n"
        "import repro_torch.serving.cache, repro_torch.models.attention\n"
        "import repro_torch.models.ssm, repro_torch.models.moe\n"
        "import repro_torch.models.transformer\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
