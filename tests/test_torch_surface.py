"""The port's coverage of the JAX package, pinned: every public name of the
reference and every one of its examples has a counterpart in the port of
the same name at the same path, or stands in one table here, which names
the counterpart or the reason, from ``ROADMAP.md``'s "Left out on purpose",
that it is left out.

Names are read with ``ast`` from the sources (top-level functions, classes
and assignments that do not start with an underscore); the packages'
``__all__`` lists are read by import."""

import ast
import importlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")
PACKAGES = ("core", "graph", "streams", "fault", "launch")

#: a reference name (``path::name`` under src/repro, or a whole file) that
#: the port has under another name or at another place -> that counterpart
#: (``path::name`` under src/repro_torch; ``Class.method`` for a method)
RENAMED = {
    "core/engine.py::superstep_spmd": "core/engine.py::superstep",
    "core/engine.py::superstep_logged_spmd":
        "core/engine.py::superstep_logged",
    "kernels/edge_combine.py::edge_combine_group":
        "kernels/edge_combine.py::edge_combine",
    "kernels/ops.py::edge_combine": "kernels/edge_combine.py::edge_combine",
    "kernels/ops.py::digest": "kernels/digest.py::digest",
    "kernels/ref.py::edge_combine_ref":
        "kernels/edge_combine.py::edge_combine_plain",
    "kernels/ref.py::digest_ref": "kernels/digest.py::digest_plain",
    # the oracle of a MoE combine kernel that the reference never wrote
    "kernels/ref.py::moe_combine_ref": "models/moe.py::moe_ffn",
    # the LM specs of the reference's launch/mesh.py
    "launch/mesh.py::param_specs": "launch/lm_mesh.py::param_specs",
    "launch/mesh.py::batch_specs_tree": "launch/lm_mesh.py::batch_specs_tree",
    "launch/mesh.py::cache_specs_tree": "launch/lm_mesh.py::cache_specs_tree",
    "launch/mesh.py::dp_axes": "launch/lm_mesh.py::dp_axes",
    "launch/mesh.py::make_production_mesh":
        "launch/lm_mesh.py::make_production_mesh",
    # the H100's rates in place of the TPU's
    "launch/roofline.py::HBM_BW": "launch/roofline.py::HBM_BYTES_PER_S",
    "launch/roofline.py::PEAK_FLOPS":
        "launch/roofline.py::BF16_DENSE_FLOPS_PER_S",
    # a pricing choice of the dry run: run_cell(flat_heads=True)
    "models/attention.py::set_flat_heads": "launch/dryrun.py::run_cell",
    # norm scales are drawn as the constant 0 with the other constant leaves
    "models/layers.py::init_rms": "models/transformer.py::CONST_LEAVES",
    # the activation rules: a spec computed, nothing pinned on one process
    "models/sharding.py::set_rules": "models/sharding.py::rules",
    "models/sharding.py::clear_rules": "models/sharding.py::rules",
    "models/sharding.py::constrain": "models/sharding.py::act_spec",
    "models/sharding.py::act_btd": "models/sharding.py::act_spec",
    "models/sharding.py::act_bshd": "models/sharding.py::act_spec",
    "models/sharding.py::act_bsf": "models/sharding.py::act_spec",
    "models/sharding.py::act_logits": "models/sharding.py::act_spec",
    "models/sharding.py::act_ecd": "models/sharding.py::act_spec",
    # the model's functions are methods of Transformer
    "models/transformer.py::forward": "models/transformer.py::Transformer.forward",
    "models/transformer.py::apply_stack":
        "models/transformer.py::Transformer.apply_stack",
    "models/transformer.py::encoder_forward":
        "models/transformer.py::Transformer.encoder_forward",
    # examples: the LM ones are the port's launchers and a method
    "examples/serve_lm.py": "launch/serve.py::main",
    "examples/train_lm.py": "launch/train.py::main",
    "examples/moe_expert_stats.py": "models/transformer.py::Transformer.moe_stats",
}

#: a reference name or file left out of the port -> the words under which
#: ``ROADMAP.md``'s "Left out on purpose" gives the reason
LEFT_OUT = {
    "compat.py": "src/repro/compat.py",
    "analysis": "src/repro/analysis/",
    "graph/kblocks.py": "graph/kblocks.py",
    "kernels/ops.py::window_first_mask": "window_first_mask",
    "core/elastic.py::simulate_failure_and_rescale":
        "simulate_failure_and_rescale",
    "launch/dryrun.py::lower_cell": "lower_cell",
    "launch/dryrun.py::analyze": "analyze",
    "launch/roofline.py::collective_bytes_from_text":
        "collective_bytes_from_text",
    "launch/roofline.py::ICI_BW": "no link rate is assumed",
    "launch/mesh.py::to_shardings": "to_shardings",
}


def _public(path):
    """Top-level public names of a source file: functions, classes and
    assigned names; for a class, also ``Class.method``."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def _modules(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def _left_out(rel, name=None):
    keys = [rel, rel.split("/")[0]] + ([f"{rel}::{name}"] if name else [])
    return any(k in LEFT_OUT for k in keys)


def _resolves(target):
    path, _, name = target.partition("::")
    full = os.path.join(PORT, path)
    return os.path.exists(full) and (not name or name in _public(full))


REF_MODULES = _modules(REF)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    """Each public top-level name of a reference module is in the port's
    module at the same path, or in the table."""
    if _left_out(rel):
        return
    port = os.path.join(PORT, rel)
    have = _public(port) if os.path.exists(port) else set()
    missing = [n for n in sorted(_public(os.path.join(REF, rel)))
               if "." not in n and n not in have
               and f"{rel}::{n}" not in RENAMED and not _left_out(rel, n)]
    assert not missing, f"{rel}: {missing}"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_have_counterparts(pkg):
    """Every name in ``repro.<pkg>.__all__`` is exported by
    ``repro_torch.<pkg>``, or the table maps the module that defines it."""
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = []
    for name in ref.__all__:
        if hasattr(port, name):
            continue
        mod = getattr(getattr(ref, name), "__module__", "")
        rel = mod.replace("repro.", "", 1).replace(".", "/") + ".py"
        if f"{rel}::{name}" not in RENAMED and not _left_out(rel, name):
            missing.append(name)
    assert not missing, missing


@pytest.mark.parametrize("example", sorted(
    f for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py")))
def test_every_example_has_a_twin(example):
    rel = f"examples/{example}"
    target = RENAMED.get(rel, rel)
    assert _resolves(target), (rel, target)


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_counterpart_exists(key):
    """The table names a counterpart that exists, for a reference name that
    exists and that the port does not have at the same path."""
    rel, _, name = key.partition("::")
    ref_path = os.path.join(REF if not rel.startswith("examples/") else ROOT,
                            rel)
    assert os.path.exists(ref_path), key
    if name:
        assert name in _public(ref_path), key
        port = os.path.join(PORT, rel)
        assert not (os.path.exists(port) and name in _public(port)), (
            f"{key} is at the same path in the port: drop it from the table")
    assert _resolves(RENAMED[key]), RENAMED[key]


def _roadmap_left_out():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    m = re.search(r"\*\*Left out on purpose:\*\*(.*?)\n\*\*", text, re.S)
    assert m, "ROADMAP.md has no 'Left out on purpose' list"
    return " ".join(m.group(1).split())


@pytest.mark.parametrize("key", sorted(LEFT_OUT))
def test_left_out_names_have_their_reason_in_the_roadmap(key):
    rel, _, name = key.partition("::")
    assert os.path.exists(os.path.join(REF, rel)), key
    if name:
        assert name in _public(os.path.join(REF, rel)), key
    assert LEFT_OUT[key] in _roadmap_left_out(), key


def test_the_renames_stand_in_the_roadmap():
    """The renames that users meet first are in the roadmap's list too."""
    text = _roadmap_left_out()
    for word in ("superstep_spmd", "launch/lm_mesh.py", "set_flat_heads",
                 "Transformer"):
        assert word in text, word
