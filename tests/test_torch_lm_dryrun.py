"""The port's LM dry run (``repro_torch.launch.lm_mesh``, ``dryrun.run_cell``,
``roofline``'s LM counts, ``perf``'s A and B variants, ``report`` and
``finalize_report``) on the CPU, held against the JAX package: the
sharding specs leaf by leaf, every supported cell's arguments (shapes,
dtypes, specs) and their sharded bytes, the skips, ``_fit`` for each
``act_*``, the activation model, and the useful-work terms. The reference's
trees come from ``abstract_params`` and ``abstract_caches``; its mesh is a
fake ``Mesh`` over the one CPU device (as ``tests/test_launch.py``'s);
nothing is compiled. ``repro.launch.dryrun`` and ``repro.launch.perf`` set
``XLA_FLAGS`` on import, so their functions are read from the source with
``ast``."""

import ast
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import repro.configs as rcfg
import repro.launch.mesh as rmesh
import repro.launch.roofline as rroof
import repro.models.attention as rattn
import repro.models.sharding as rshard
import repro_torch.configs as tcfg
import repro_torch.models.attention as tattn
from repro.data.tokens import batch_specs as ref_batch_specs
from repro.models.transformer import abstract_params as ref_abstract_params
from repro.serving.cache import abstract_caches as ref_abstract_caches
from repro_torch.launch import dryrun, finalize_report, lm_mesh, perf, report
from repro_torch.launch import roofline
from repro_torch.models import sharding
from repro_torch.models.transformer import param_shapes, tree_slots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DRYRUN = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
ARCHS = sorted(tcfg.ARCHS)
SHAPES = list(tcfg.SHAPES)
MESHES = [False, True]  # multi_pod
CELLS = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES
         if tcfg.cell_supported(a, s)[0]]
MFLOPS_RTOL = 1e-9


def _fake_mesh(multi_pod: bool) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.empty(shape, dtype=object)
    for i in range(devs.size):
        devs.flat[i] = jax.devices()[0]
    return Mesh(devs, names)


@functools.lru_cache(maxsize=None)
def _ref_source_functions() -> dict:
    """The reference dry run's helpers, compiled from its source."""
    with open(REF_DRYRUN) as fh:
        tree = ast.parse(fh.read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in (
                "_opt_state_abstract", "_media_spec",
                "_activation_model_bytes"))
            or (isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "WHISPER_SELF_LEN")]
    ns = dict(jax=jax, jnp=jnp)
    exec(compile(ast.Module(body=keep, type_ignores=[]), REF_DRYRUN,
                 "exec"), ns)
    return ns


def _ref_record_keys() -> set:
    """The keys of the reference's LM record: ``analyze``'s ``rec =
    dict(...)`` and ``roofline_terms``' (``**terms``)."""
    with open(REF_DRYRUN) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "analyze")
    rec = next(n for n in fn.body if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "rec")
    keys = {kw.arg for kw in rec.value.keywords if kw.arg}
    terms = rroof.roofline_terms(
        rcfg.ARCHS["minitron-4b"], dict(kind="train", seq_len=8,
                                        global_batch=2),
        flops=1.0, bytes_accessed=1.0, collective_bytes=1.0, n_chips=2)
    times = {"lower_s", "compile_s"}  # the reference's ``**times``
    return keys | set(terms) | times


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return ref_abstract_params(rcfg.ARCHS[arch])


def _walk(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _layer_slot(cfg, i: int):
    """A port layer's place in the reference's stacked trees."""
    n_pro, n_pat = len(cfg.prologue), len(cfg.pattern)
    if i < n_pro:
        return ("prologue", i), None
    g, pi = divmod(i - n_pro, n_pat)
    return ("groups", pi), g


def _same_leaf(port_t, port_spec, ref_leaf, ref_spec, g, what):
    """A port leaf against the reference's (a slice ``g`` of a stacked
    one): shape, dtype and spec."""
    shape = tuple(ref_leaf.shape)
    spec = tuple(ref_spec)
    if g is not None:
        shape, spec = shape[1:], spec
        assert spec[0] is None, what
        spec = spec[1:]
    assert tuple(port_t.shape) == shape, what
    assert port_t.element_size() == np.dtype(ref_leaf.dtype).itemsize, what
    assert str(port_t.dtype).split(".")[-1] == np.dtype(ref_leaf.dtype).name \
        or (port_t.dtype == torch.bfloat16 and ref_leaf.dtype == jnp.bfloat16), what
    assert tuple(port_spec) == spec, (what, port_spec, spec)


def _ref_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n *= mesh.shape[a]
        nb = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        assert nb % n == 0
        total += nb // n
    return total


def _ref_cell(arch, shape, multi_pod):
    """The reference's ``lower_cell`` arguments and their specs: a list of
    ``(tree, spec tree)``, and its cache tree (None for train)."""
    ns = _ref_source_functions()
    cfg = rcfg.ARCHS[arch]
    info = rcfg.SHAPES[shape]
    S, B, kind = info["seq_len"], info["global_batch"], info["kind"]
    mesh = _fake_mesh(multi_pod)
    params = _ref_params(arch)
    pspecs = rmesh.param_specs(params, mesh)
    out = [(params, pspecs)]
    if kind == "train":
        opt = ns["_opt_state_abstract"](params, cfg.grad_compress)
        ospecs = {k: (P() if k == "step" else pspecs) for k in opt}
        batch = ref_batch_specs(cfg, S, B)
        if cfg.family == "audio":
            batch["media"], _ = ns["_media_spec"](cfg, B, S)
        out += [(opt, ospecs), (batch, rmesh.batch_specs_tree(batch, mesh))]
        return out, None, None, mesh
    W = ns["WHISPER_SELF_LEN"]
    tok_len = W if cfg.family == "audio" else S
    caches = ref_abstract_caches(cfg, B, max_len=tok_len,
                                 n_media=S if cfg.family == "audio" else None)
    cspecs = rmesh.cache_specs_tree(caches, mesh)
    out.append((caches, cspecs))
    if kind == "prefill":
        toks = jax.ShapeDtypeStruct((B, tok_len), jnp.int32)
        out.append((toks, rmesh.batch_specs_tree(toks, mesh)))
        if cfg.family in ("audio", "vlm"):
            media, _ = ns["_media_spec"](cfg, B, S)
            out.append((media, rmesh.batch_specs_tree(media, mesh)))
    else:
        tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
        out += [(tok, rmesh.batch_specs_tree(tok, mesh)),
                (jax.ShapeDtypeStruct((), jnp.int32), P())]
    return out, caches, cspecs, mesh


# --------------------------------------------------------------------------
# the sharding rules against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, mode, multi_pod):
    """Every weight's spec is the reference's ``param_specs`` leaf's (a
    stacked leaf's less its leading None), and every reference leaf (each
    layer of a stacked one) is a port weight."""
    cfg = tcfg.ARCHS[arch]
    ref_tree = _ref_params(arch)
    ref_specs = rmesh.param_specs(ref_tree, _fake_mesh(multi_pod), mode=mode)
    specs = lm_mesh.param_specs(cfg, lm_mesh.make_production_mesh(
        multi_pod=multi_pod), mode)
    slots = tree_slots(cfg)
    shapes = param_shapes(cfg)
    assert set(specs) == set(shapes)
    for name, spec in specs.items():
        path, g = slots[name]
        leaf = _walk(ref_tree, path)
        want = tuple(_walk(ref_specs, path))
        if g is not None:
            assert want[0] is None, name
            want = want[1:]
        assert spec == want, (name, spec, want)
        assert tuple(leaf.shape[1 if g is not None else 0:]) == shapes[name]
    n_ref = sum(leaf.shape[0] if any(getattr(k, "key", None) in
                                     ("groups", "encoder") for k in path)
                else 1
                for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree))
    assert n_ref == len(specs)


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_cell_arguments_equal_the_references(arch, shape, multi_pod):
    """A supported cell's caches, batch, tokens, media and optimizer state:
    each leaf's shape, dtype and spec the reference's ``lower_cell``
    arguments', the caches named by the port's fields."""
    cfg = tcfg.ARCHS[arch]
    mesh = lm_mesh.make_production_mesh(multi_pod=multi_pod)
    info = tcfg.SHAPES[shape]
    dp = lm_mesh.dp_axes(mesh)
    with sharding.rules(batch=dp if len(dp) > 1 else dp[0], model="model",
                        mesh=mesh):
        args = dryrun.cell_arguments(cfg, info, mesh)
    ref, caches, cspecs, _ = _ref_cell(arch, shape, multi_pod)
    if info["kind"] == "train":
        (opt, ospecs), (batch, bspecs) = ref[1], ref[2]
        assert set(args) == {"params", "step", "batch"} | set(
            k for k in opt if k != "step")
        for st in ("mu", "nu", "err"):
            if st not in opt:
                continue
            slots = tree_slots(cfg)
            for name, (t, spec) in args[st].items():
                path, g = slots[name]
                _same_leaf(t, spec, _walk(opt[st], path),
                           _walk(ospecs[st], path), g, (st, name))
        t, spec = args["step"]["step"]
        _same_leaf(t, spec, opt["step"], P(), None, "step")
        assert set(args["batch"]) == set(batch)
        for k, (t, spec) in args["batch"].items():
            _same_leaf(t, spec, batch[k], bspecs[k], None, k)
        return
    n_ref = sum(leaf.shape[0] if getattr(path[0], "key", None) == "groups"
                else 1
                for path, leaf in jax.tree_util.tree_leaves_with_path(caches))
    assert len(args["caches"]) == n_ref
    for name, (t, spec) in args["caches"].items():
        _, i, field, leaf = name.split(".")
        path, g = _layer_slot(cfg, int(i))
        _same_leaf(t, spec, _walk(caches, path)[field][leaf],
                   _walk(cspecs, path)[field][leaf], g, name)
    rest = ref[2:]
    if info["kind"] == "prefill":
        port = [args["tokens"]["tokens"]] + (
            [args["media"]["media"]] if "media" in args else [])
    else:
        port = [args["tokens"]["token"], args["tokens"]["pos"]]
    assert len(port) == len(rest)
    for (t, spec), (leaf, rspec) in zip(port, rest):
        _same_leaf(t, spec, leaf, rspec, None, shape)


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_argument_bytes_equal_the_references_trees(arch, shape, multi_pod):
    """``argument_bytes``: the reference's argument trees' bytes under its
    specs, exactly."""
    ref, _, _, mesh = _ref_cell(arch, shape, multi_pod)
    want = sum(_ref_bytes(t, s, mesh) for t, s in ref)
    rec = dryrun.run_cell(arch, shape, multi_pod)
    assert rec["ok"] and rec["argument_bytes"] == want


def test_skips_are_the_references():
    """``cell_supported`` agrees on all 40 (arch, shape) pairs, and a
    skipped cell's record is the reference's."""
    for arch in ARCHS:
        for shape in SHAPES:
            assert tcfg.cell_supported(arch, shape) == \
                rcfg.cell_supported(arch, shape)
    assert len(CELLS) == 66
    rec = dryrun.run_cell("minitron-4b", "long_500k", True)
    assert rec == dict(arch="minitron-4b", shape="long_500k",
                       mesh="multipod", ok=False, skipped=True,
                       reason=rcfg.cell_supported("minitron-4b",
                                                  "long_500k")[1])


FIT_SHAPES = {"btd": [(256, 4096, 12288), (1, 4096, 64), (32, 7, 8)],
              "bshd": [(256, 4096, 96, 128), (3, 5, 8, 16)],
              "bsf": [(256, 4096, 33792), (16, 1, 30)],
              "logits": [(256, 4096, 256000), (128, 51866), (1, 262144)],
              "ecd": [(128, 81921, 4096), (64, 3, 2048), (8, 2, 2)]}


@pytest.mark.parametrize("seq", [None, "model"])
@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("kind", list(FIT_SHAPES))
def test_act_specs_equal_the_references_fit(kind, multi_pod, seq,
                                            monkeypatch):
    """Under the same rules, ``act_spec`` is the spec the reference's
    ``act_*`` pins (its ``with_sharding_constraint`` caught)."""
    seen = []
    monkeypatch.setattr(rshard.jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    mesh = lm_mesh.make_production_mesh(multi_pod=multi_pod)
    dp = lm_mesh.dp_axes(mesh)
    batch = dp if len(dp) > 1 else dp[0]
    fn = {"btd": "act_btd", "bshd": "act_bshd", "bsf": "act_bsf",
          "logits": "act_logits", "ecd": "act_ecd"}[kind]
    for shape in FIT_SHAPES[kind]:
        x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        with rshard.rules(batch=batch, model="model", seq=seq,
                          mesh=_fake_mesh(multi_pod)):
            getattr(rshard, fn)(x)
        with sharding.rules(batch=batch, model="model", seq=seq, mesh=mesh):
            got = sharding.act_spec(kind, shape)
        assert got == tuple(seen.pop()), (kind, shape)
    assert sharding.act_spec("btd", (2, 3, 4)) == (None, None, None)


@pytest.mark.parametrize("multi_pod", MESHES)
def test_activation_model_equals_the_references(multi_pod):
    """``_activation_model_bytes``, copied, against the reference's
    function compiled from its source, on every cell and a few shapes of
    one GPU."""
    ref = _ref_source_functions()["_activation_model_bytes"]
    n = 512 if multi_pod else 256
    infos = list(tcfg.SHAPES.values()) + [
        dict(seq_len=1100, global_batch=4, kind="prefill"),
        dict(seq_len=2048, global_batch=1, kind="train")]
    for arch in ARCHS:
        for info in infos:
            for chips in (n, 1):
                assert dryrun._activation_model_bytes(
                    tcfg.ARCHS[arch], info, chips) == ref(
                        rcfg.ARCHS[arch], info, chips)


# --------------------------------------------------------------------------
# the 80 cells and their records
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def all_records(tmp_path_factory):
    """``--all`` and ``--all --multipod`` through the command line."""
    out = str(tmp_path_factory.mktemp("dry") / "d.json")
    assert dryrun.main(["--all", "--out", out]) == 0
    assert dryrun.main(["--all", "--multipod", "--out", out]) == 0
    with open(out) as fh:
        return json.load(fh)


def test_all_80_cells(all_records):
    """80 records: 66 ok, the reference's 14 skips with its reason, none
    failed; an ok record has the reference's keys less what compiling
    gives, plus ``fits`` and ``f32_flops_per_chip``."""
    recs = all_records
    assert len({(r["arch"], r["shape"], r["mesh"]) for r in recs}) == 80
    ok = [r for r in recs if r["ok"]]
    skipped = [r for r in recs if r.get("skipped")]
    assert len(ok) == 66 and len(skipped) == 14
    for r in skipped:
        assert r["reason"] == rcfg.cell_supported(r["arch"], r["shape"])[1]
    want = (_ref_record_keys() - {"lower_s", "compile_s", "cpu_temp_bytes"}) \
        | {"fits", "f32_flops_per_chip"}
    for r in ok:
        assert set(r) == want, set(r) ^ want
        assert r["flops_per_chip"] > r["f32_flops_per_chip"] > 0
        assert r["bytes_per_chip"] > 0 and r["t_collective_s"] is None
        assert r["peak_bytes_model"] >= r["argument_bytes"] > 0
        assert r["fits"] == (r["peak_bytes_model"] <= 80e9)


def test_useful_flops_equal_the_references_roofline(all_records):
    """``model_flops_per_chip`` is the reference's ``roofline_terms``' on
    the same cell (rtol 1e-9); ``useful_flops_ratio`` is positive (it may
    pass 1: 6·N·D and 2·N·D count the embedding table, which no product
    computes, and a prefill's logits are one position's); the compute term
    is the bf16 operations at 989e12/s plus the float32 ones at 67e12/s."""
    for r in all_records:
        if not r["ok"]:
            continue
        info = rcfg.SHAPES[r["shape"]]
        n = 512 if r["mesh"] == "multipod" else 256
        ref = rroof.roofline_terms(
            rcfg.ARCHS[r["arch"]], info, flops=r["flops_per_chip"],
            bytes_accessed=r["bytes_per_chip"],
            collective_bytes=r["collective_bytes_per_chip"], n_chips=n)
        assert r["model_flops_per_chip"] == pytest.approx(
            ref["model_flops_per_chip"], rel=MFLOPS_RTOL)
        assert r["useful_flops_ratio"] == pytest.approx(
            ref["useful_flops_ratio"], rel=MFLOPS_RTOL)
        assert r["useful_flops_ratio"] > 0
        low = r["flops_per_chip"] - r["f32_flops_per_chip"]
        assert r["t_compute_s"] == pytest.approx(
            low / 989e12 + r["f32_flops_per_chip"] / 67e12, rel=1e-12)
        assert r["t_memory_s"] == pytest.approx(r["bytes_per_chip"] / 3.35e12,
                                                rel=1e-12)


def test_link_rate_prices_the_collectives():
    rec = dryrun.run_cell("minitron-4b", "train_4k", False,
                          link_bytes_per_s=1e11)
    assert rec["t_collective_s"] == rec["collective_bytes_per_chip"] / 1e11
    assert rec["dominant"] in ("compute", "memory", "collective")


def test_dry_run_is_host_arithmetic_in_a_fresh_process(tmp_path):
    """In a fresh interpreter: every new module imports, ``--all`` on both
    meshes runs, and neither jax nor the JAX package is loaded, the card
    never touched, no process group started."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "import repro_torch.launch.lm_mesh, repro_torch.models.sharding\n"
        "import repro_torch.launch.finalize_report\n"
        "from repro_torch.launch import dryrun\n"
        f"out = {str(tmp_path / 'd.json')!r}\n"
        "assert dryrun.main(['--all', '--out', out]) == 0\n"
        "assert dryrun.main(['--all', '--multipod', '--out', out]) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.count("SKIP") == 14


# --------------------------------------------------------------------------
# the collectives against a hand count
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq_shard", [False, True])
def test_collectives_against_a_hand_count(seq_shard):
    """minitron-4b ``.reduced()`` (2 layers, d 64, 4 heads of 16, 2 KV
    heads, d_ff 128, vocab 256, bf16, no remat) training on B 4 × S 8 at
    mesh (data 2, model 2). Every 2-d weight is sharded over both axes:
    gathered over 'data' twice (forward, backward) at half its bytes, its
    gradient reduce-scattered at a quarter; the norms' gradients
    all-reduced whole (twice their bytes). Each layer's wo and w_down sum
    over 'model' twice, X = 2 × 8 × 64 × 2 bytes: an all-reduce of 2X, or
    under seq_shard a reduce-scatter of X/2 and an all-gather of X."""
    cfg = dataclasses.replace(tcfg.ARCHS["minitron-4b"].reduced(),
                              seq_shard=seq_shard)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.remat) == \
        (2, 64, 4, 2, 16, 128, 256, False)
    mats = [256 * 64, 256 * 64] + 2 * [64 * 64, 64 * 32, 64 * 32, 64 * 64,
                                       64 * 128, 64 * 128, 128 * 64]
    norms = [64] + 2 * [64, 64]
    X = 2 * 8 * 64 * 2
    gather = 2 * sum(2 * m // 2 for m in mats)
    want = {"all-gather": gather, "reduce-scatter": sum(2 * m // 4
                                                        for m in mats),
            "all-reduce": sum(2 * 2 * n for n in norms)}
    tp = 2 * 2  # two projections a layer, two layers
    if seq_shard:
        want["reduce-scatter"] += 2 * tp * X // 2
        want["all-gather"] += 2 * tp * X
    else:
        want["all-reduce"] += 2 * tp * 2 * X
    rec = dryrun.run_cell(cfg.name, "train_8", cfg=cfg, mesh_shape=(2, 2),
                          shape_info=dict(seq_len=8, global_batch=4,
                                          kind="train"))
    assert rec["mesh"] == "2x2"
    assert rec["collective_breakdown"] == want
    assert rec["collective_bytes_per_chip"] == sum(want.values())


def test_one_gpu_cell_has_no_collectives():
    cfg = tcfg.ARCHS["gemma3-12b"].reduced()
    for kind in ("train", "prefill", "decode"):
        rec = dryrun.run_cell(cfg.name, kind, cfg=cfg, mesh_shape=(1, 1),
                              shape_info=dict(seq_len=16, global_batch=2,
                                              kind=kind))
        assert rec["collective_breakdown"] == {}, kind
        assert rec["mesh"] == "1x1"


def test_moe_all_to_all_against_a_hand_count():
    """qwen3-moe ``.reduced()`` (8 experts, top 2, expert d_ff 32) decoding
    B 4 at mesh (2, 2): C = int(1.25 · 2 · 4 / 8) + 1 = 2; each layer's
    (8, 2, 64) bf16 buffer split over 'model' is 2,048 bytes a GPU, moved
    twice (dispatch, combine)."""
    cfg = tcfg.ARCHS["qwen3-moe-235b-a22b"].reduced()
    rec = dryrun.run_cell(cfg.name, "decode", cfg=cfg, mesh_shape=(2, 2),
                          shape_info=dict(seq_len=16, global_batch=4,
                                          kind="decode"))
    assert rec["collective_breakdown"]["all-to-all"] == \
        cfg.n_layers * 2 * (8 * 2 * 64 * 2 // 2)


def test_decode_bytes_against_a_hand_count():
    """minitron-4b ``.reduced()`` (2 layers, d 64, 4 heads of 16, 2 KV
    heads, d_ff 128, vocab 256, bf16) decoding B 4 against caches of 16
    at mesh (data 2, model 2), under the ``train`` specs. A GPU's HBM
    bytes: each weight once at its share after the 'data' gather (the 2-d
    ones over 'model', the norms whole); its quarter of the K/V caches
    (batch over 'data', sequence over 'model') and the position tables
    whole, once, and nowhere else; the products' activations over their
    splits (a projection's B 4 tokens over 'data' and its weight over
    'model'; the attention over the cache's split; the logits over
    (data, model)). Its collectives: the FSDP gather of every 2-d weight,
    and all-reduces of wo's and w_down's (2, 64) output and of each
    layer's partial softmax: the (2, 1, 4, 16) bf16 output and its
    float32 max and sum a (batch, head)."""
    cfg = tcfg.ARCHS["minitron-4b"].reduced()
    B, L, d, H, Hkv, hd, f, V = 4, 16, 64, 4, 2, 16, 128, 256
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (2, d, H, Hkv, hd, f, V)
    mats = [V * d, V * d] + 2 * [d * H * hd, d * Hkv * hd, d * Hkv * hd,
                                 H * hd * d, d * f, d * f, f * d]
    weights = sum(2 * m // 2 for m in mats) + 5 * 2 * d
    caches = 2 * 2 * (2 * B * L * Hkv * hd // 4) + 2 * 4 * L
    proj = lambda din, dout: 2 * B * (din + dout) // 4
    layer = (proj(d, H * hd) + 2 * proj(d, Hkv * hd) + proj(H * hd, d)
             + 2 * proj(d, f) + proj(f, d)
             + (2 * B * H * hd + 8 * H * B * L) // 4  # QK: q, f32 logits
             + (2 * 2 * H * B * L + 2 * B * H * hd) // 4)  # PV: p, out
    logits = B * (2 * d + 4 * V) // 4
    rec = dryrun.run_cell(cfg.name, "decode", cfg=cfg, mesh_shape=(2, 2),
                          shape_info=dict(seq_len=L, global_batch=B,
                                          kind="decode"))
    assert rec["bytes_per_chip"] == weights + caches + 2 * layer + logits
    tp = 2 * (B // 2) * d * 2
    combine = 2 * (B // 2) * H * (hd * 2 + 2 * 4)
    assert rec["collective_breakdown"] == {
        "all-gather": sum(2 * m // 2 for m in mats),
        "all-reduce": 2 * (2 * tp + combine)}


# --------------------------------------------------------------------------
# the one-GPU cells of the smoke, and the bounds it prints
# --------------------------------------------------------------------------

def test_one_gpu_arguments_equal_the_tensors():
    """At mesh (1, 1) a cell's ``argument_bytes`` are the bytes of the
    tensors a run holds: the weights, caches, tokens and media of a
    prefill, the weights, moments, step and batch of a training step
    (reduced configs, on the CPU; Whisper's reference prefill holds 448
    decoder tokens, not a prompt's)."""
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.cache import cache_bytes, make_caches
    from repro_torch.training.train import init_train_state

    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    for arch in ("gemma3-12b", "llama-3.2-vision-90b", "deepseek-v2-lite-16b",
                 "mamba2-2.7b", "hymba-1.5b"):
        cfg = tcfg.ARCHS[arch].reduced()
        model = init_params(cfg, 0, "cpu")
        B, S, G = 2, 12, 4
        batch = synthetic_batch(cfg, 0, S, B, device="cpu")
        caches = make_caches(cfg, B, S + G, device="cpu")
        rec = dryrun.run_cell(cfg.name, "prefill", cfg=cfg, mesh_shape=(1, 1),
                              shape_info=dict(seq_len=S, global_batch=B,
                                              kind="prefill",
                                              cache_len=S + G))
        media = [batch["media"]] if "media" in batch else []
        assert rec["argument_bytes"] == size(model.parameters()) \
            + cache_bytes(caches) + size([batch["tokens"]] + media), arch
        opt = init_train_state(cfg, model)
        rec = dryrun.run_cell(cfg.name, "train", cfg=cfg, mesh_shape=(1, 1),
                              shape_info=dict(seq_len=S, global_batch=B,
                                              kind="train"))
        assert rec["argument_bytes"] == size(model.parameters()) \
            + size(opt["mu"].values()) + size(opt["nu"].values()) \
            + size([opt["step"]]) + size(batch.values()), arch


def _old_prefill_flops(cfg, B, S, n_media=0):
    """The count ``chip_smoke.py`` held before it moved to
    ``launch/roofline.py``, written out in one loop as it was."""
    from repro_torch.models.ssm import pick_chunk
    from repro_torch.models.transformer import layer_specs

    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T, tok = n_media, B * S

    def pairs(window):
        return B * sum(min(p + 1, window or S) for p in range(S))

    def attn(n_tok, n_pairs, kv_tok):
        return (2 * n_tok * 2 * d * H * hd + 2 * kv_tok * 2 * d * Hkv * hd
                + 4 * H * hd * n_pairs)

    total = 2 * B * d * cfg.vocab
    for spec in layer_specs(cfg):
        if spec.kind in ("attn", "hybrid"):
            total += attn(tok, pairs(spec.window), tok)
        if spec.kind in ("ssm", "hybrid"):
            di, N, nh, K = (cfg.d_ssm_inner, cfg.ssm_state, cfg.n_ssm_heads,
                            cfg.ssm_conv)
            L, shd = pick_chunk(S, cfg.ssm_chunk), cfg.ssm_head_dim
            total += (2 * tok * (d * (2 * di + 2 * N + nh) + di * d)
                      + 2 * tok * K * (di + 2 * N)
                      + 2 * tok * (L * N + nh * L * shd + 2 * nh * shd * N))
        if spec.kind == "cross":
            total += attn(tok, B * S * T, B * T)
        if spec.kind == "mla":
            r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
            total += (2 * tok * (d * H * (hd + rd) + d * (r + rd) + H * hd * d
                                 + r * H * 2 * hd)
                      + 2 * H * (2 * hd + rd) * pairs(None))
        if cfg.n_enc_layers:
            total += attn(tok, B * S * T, B * T)
        if spec.ffn == "dense":
            total += 2 * tok * 3 * d * cfg.d_ff
        elif spec.ffn == "moe":
            E, f = cfg.n_experts, cfg.moe_dff
            C = int(cfg.capacity_factor * cfg.topk * tok / E) + 1
            total += (2 * tok * d * E + 2 * E * C * 3 * d * f
                      + 2 * tok * 3 * d * f * cfg.n_shared_experts)
    for _ in range(cfg.n_enc_layers):
        total += attn(B * T, B * T * T, B * T) + 2 * B * T * 3 * d * cfg.d_ff
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_moved_prefill_count_is_the_smokes(arch):
    cfg = tcfg.ARCHS[arch]
    for B, S, T in ((4, 1100, 0), (4, 64, 1500), (2, 96, 16), (1, 7, 3)):
        assert roofline.lm_prefill_flops(cfg, B, S, T) == \
            _old_prefill_flops(cfg, B, S, T)


def test_pinned_bounds():
    """The bounds ``chip_smoke.py`` prints: minitron-4b's training step,
    1 × 2,048 with remat, 60.03 + 168.86 + 33.47 = 262.365 ms; gemma3-12b's
    prefill of 4 × 1,100 by operations, 97.653 ms (an earlier count from
    ``n_params``, weights and norms alike, gave 97.657)."""
    b = roofline.lm_train_bound_ms(tcfg.ARCHS["minitron-4b"], 1, 2048)
    assert (round(b["low_ms"], 2), round(b["f32_ms"], 2),
            round(b["bytes_ms"], 2)) == (60.03, 168.86, 33.47)
    assert round(sum(b.values()), 3) == 262.365
    assert round(roofline.lm_prefill_bound_ms(
        tcfg.ARCHS["gemma3-12b"], 4, 1100), 3) == 97.653


def test_decode_count():
    """One decode step: every slot of each ring, two operations a weight a
    token, the logits of B tokens; for a dense GQA model written out."""
    cfg = tcfg.ARCHS["minitron-4b"]
    B, L = 3, 100
    d, H, Hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    layer = (2 * B * (2 * d * H * hd + 2 * d * Hkv * hd + 3 * d * f)
             + 4 * H * hd * B * L)
    work = roofline.lm_work(cfg, B, 1, "decode", cache_len=L)
    assert sum(w.ops for w in work) == \
        cfg.n_layers * layer + 2 * B * d * cfg.vocab


# --------------------------------------------------------------------------
# the §Perf variants
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def variants():
    base_a = dryrun.run_cell("command-r-plus-104b", "train_4k", False)
    base_b = dryrun.run_cell("qwen3-moe-235b-a22b", "decode_32k", False)
    out = {t: perf.variant_A(t) for t in ("A1", "A2", "A3", "A4")}
    out.update({t: perf.variant_B(t) for t in ("B1", "B2", "B3")})
    return base_a, base_b, out


def test_variant_a_moves_its_terms(variants):
    """A1 (flat heads): the attention logits split 16 ways: operations
    fall, float32 ones (the logits) most, the arguments and collectives
    stay. A2 (no seq_shard): the TP sums become all-reduces, collective
    bytes rise. A3 (grad_compress): the arguments rise by ``err``, a float32
    copy of the weights sharded as they are. A4 (no remat): operations
    fall by the recomputed forward; ``peak_bytes_model`` stays (the copied
    activation model does not see remat)."""
    base, _, v = variants
    a1, a2, a3, a4 = v["A1"], v["A2"], v["A3"], v["A4"]
    assert [r["variant"] for r in (a1, a2, a3, a4)] == ["A1", "A2", "A3",
                                                        "A4"]
    assert a1["flops_per_chip"] < base["flops_per_chip"]
    # QK (float32) and PV (bf16) do the same operations a pair
    assert base["flops_per_chip"] - a1["flops_per_chip"] == pytest.approx(
        2 * (base["f32_flops_per_chip"] - a1["f32_flops_per_chip"]),
        rel=1e-9)
    assert a1["argument_bytes"] == base["argument_bytes"]
    assert a1["collective_breakdown"] == base["collective_breakdown"]
    assert a2["collective_bytes_per_chip"] > a1["collective_bytes_per_chip"]
    assert a2["collective_breakdown"]["all-reduce"] > \
        a1["collective_breakdown"]["all-reduce"]
    assert a2["flops_per_chip"] == a1["flops_per_chip"]
    mesh = lm_mesh.make_production_mesh()
    cfg = tcfg.ARCHS["command-r-plus-104b"]
    mu = dryrun.cell_arguments(cfg, tcfg.SHAPES["train_4k"], mesh)["mu"]
    assert a3["argument_bytes"] - a1["argument_bytes"] == \
        dryrun.sharded_bytes(mu, mesh)
    assert a3["flops_per_chip"] == a1["flops_per_chip"]
    body = a1["flops_per_chip"] - a4["flops_per_chip"]
    assert body > 0
    assert a4["flops_per_chip"] - 3 * body == pytest.approx(
        3 * 2 * (256 // 16) * 4096 * cfg.d_model * cfg.vocab / 16, rel=1e-9)
    assert a4["peak_bytes_model"] == a1["peak_bytes_model"]


def test_variant_b_moves_its_terms(variants):
    """B1 (serve specs): nothing is gathered (the expert banks' 'data'
    axis splits their ff dimension, tensor parallel): a GPU reads its
    weights at its share of every axis, and the MoE operations fall 16
    ways, their partial outputs all-reduced over 'data'. B2 (flat heads)
    moves no term: decode attention is already split over 'model' on the
    cache's sequence axis, which the heads cannot add to. B3 (capacity
    1.0): the MoE buffer shrinks, its operations and all-to-all bytes with
    it."""
    _, base, v = variants
    b1, b2, b3 = v["B1"], v["B2"], v["B3"]
    cfg = tcfg.ARCHS["qwen3-moe-235b-a22b"]
    mesh = lm_mesh.make_production_mesh()
    specs = lm_mesh.param_specs(cfg, mesh, "serve")
    shapes = param_shapes(cfg)
    assert any("data" in specs[k] for k, s in shapes.items() if len(s) == 3)
    assert "all-gather" not in b1["collective_breakdown"]
    assert base["collective_breakdown"]["all-gather"] > 0
    assert b1["flops_per_chip"] < base["flops_per_chip"]
    assert b1["bytes_per_chip"] < base["bytes_per_chip"]
    assert b1["collective_breakdown"]["all-reduce"] > \
        base["collective_breakdown"]["all-reduce"]
    for key in ("flops_per_chip", "f32_flops_per_chip", "bytes_per_chip",
                "collective_breakdown", "argument_bytes"):
        assert b2[key] == b1[key], key
    assert b3["flops_per_chip"] < b1["flops_per_chip"]
    assert b3["collective_breakdown"]["all-to-all"] < \
        b1["collective_breakdown"]["all-to-all"]
    assert b3["f32_flops_per_chip"] == b1["f32_flops_per_chip"]
    with pytest.raises(KeyError):
        perf.variant_A("A5")


def test_perf_cli_writes_every_variant(tmp_path):
    out = str(tmp_path / "p.json")
    assert perf.main(["A1", "A2", "A3", "A4", "B1", "B2", "B3", "C1",
                      "--out", out]) == 0
    with open(out) as fh:
        recs = json.load(fh)
    assert [r["variant"] for r in recs] == ["A1", "A2", "A3", "A4", "B1",
                                            "B2", "B3", "C1"]


# --------------------------------------------------------------------------
# flat heads against the grouped path and the reference's flat path
# --------------------------------------------------------------------------

FLAT_TOL = 2e-6  # float32 rounding: the same sums in another batching


def _flat_attend(q, k, v, mask):
    """The attention the dry run prices under ``flat_heads``: K and V
    repeated to the H query heads before the float32 logits (the
    reference's ``set_flat_heads(True)``); ``tattn._attend``'s arguments."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)  # (B, T, H, hd)
    v = v.repeat_interleave(rep, dim=2)
    logits = (q.float().transpose(1, 2)
              @ k.float().permute(0, 2, 3, 1)) / math.sqrt(q.shape[-1])
    if mask is not None:  # (B, H, S, T)
        logits = torch.where(mask[:, None], logits, tattn.MASKED)
    p = torch.softmax(logits, dim=-1)
    return (p.to(v.dtype) @ v.transpose(1, 2)).transpose(1, 2)


def _attn_inputs(seed, B, S, T, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, S, H, hd), f(B, T, Hkv, hd), f(B, T, Hkv, hd)


@pytest.mark.parametrize("H,Hkv", [(8, 2), (4, 4), (6, 1)])
@pytest.mark.parametrize("masked", [True, False])
def test_flat_heads_compute_the_grouped_function(H, Hkv, masked):
    """Flat heads (``_flat_attend``) compute the port's grouped
    ``_attend`` within 2e-6 of its largest |value| (float32 inputs), and
    the reference's flat path on the same numpy inputs."""
    B, S, T, hd = 2, 5, 7, 16
    q, k, v = _attn_inputs(H * 10 + Hkv, B, S, T, H, Hkv, hd)
    mask = np.tril(np.ones((S, T), bool), T - S)[None].repeat(B, 0)
    if not masked:
        mask = np.ones_like(mask)
    tmask = torch.from_numpy(mask) if masked else None
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    grouped = tattn._attend(tq, tk, tv, tmask)
    flat = _flat_attend(tq, tk, tv, tmask)
    try:
        rattn.set_flat_heads(True)
        ref = np.asarray(rattn._attend(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(mask)))
    finally:
        rattn.set_flat_heads(False)
    top = float(grouped.abs().max())
    assert float((flat - grouped).abs().max()) <= FLAT_TOL * top
    assert np.abs(flat.numpy() - ref).max() <= FLAT_TOL * top


def test_flat_heads_through_a_decode_step(monkeypatch):
    """A reduced GQA model's prefill and decode logits with flat heads in
    place of the grouped attention are the grouped path's (float32
    weights, within 2e-6 of the largest |logit|)."""
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.cache import make_caches
    from repro_torch.serving.engine import decode_step, prefill

    cfg = dataclasses.replace(tcfg.ARCHS["gemma3-12b"].reduced(),
                              dtype=torch.float32)
    model = init_params(cfg, 0, "cpu")
    toks = synthetic_batch(cfg, 0, 10, 2, device="cpu")["tokens"]

    def run():
        caches = make_caches(cfg, 2, 10, device="cpu")
        return torch.stack([prefill(model, toks[:, :8], caches),
                            decode_step(model, caches, toks[:, 8:9], 8)])

    grouped = run()
    monkeypatch.setattr(tattn, "_attend", _flat_attend)
    flat = run()
    assert float((flat - grouped).abs().max()) <= \
        FLAT_TOL * float(grouped.abs().max())


# --------------------------------------------------------------------------
# the report
# --------------------------------------------------------------------------

def test_report_renders_lm_records(all_records):
    single = [r for r in all_records if r["mesh"] == "singlepod"]
    table = report.dryrun_table(single)
    assert table.count("\n") == 2 + 40 - 1
    assert "SKIP (pure full attention" in table
    assert "| command-r-plus-104b | train_4k | singlepod | – |" in table
    roof = report.roofline_table(single)
    assert roof.count("\n") == 2 + 33 - 1 and "| – |" in roof


def test_finalize_report_fills_the_markers(all_records, tmp_path, capsys):
    res = tmp_path / "d.json"
    res.write_text(json.dumps(all_records))
    doc = tmp_path / "doc.md"
    doc.write_text("# x\n<!-- DRYRUN_TABLES -->\nmid\n<!-- ROOFLINE_TABLES -->\n")
    assert finalize_report.main(["--results", str(res), "--doc",
                                 str(doc)]) == 0
    text = doc.read_text()
    assert "<!--" not in text and "mid" in text
    assert "### Dry-run (single pod, 16×16 = 256 GPUs)" in text
    assert "### Roofline (multi-pod)" in text
    assert "gemma3-12b | long_500k" in text
    capsys.readouterr()
    assert finalize_report.main(["--results", str(res)]) == 0
    printed = capsys.readouterr().out
    assert "### Dry-run (multi-pod, 2×16×16 = 512 GPUs)" in printed
    assert "<!--" not in printed
