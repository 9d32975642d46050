"""The port's twins of the two GraphD examples against the JAX package's
examples, on the CPU: each twin runs here with ``--device cpu``, each
reference example in a subprocess (as ``tests/test_system.py`` runs it),
and the two agree on the graph, the planner's choice, the results and the
lines they print."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import graph_analytics, quickstart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")
PAGERANK_TOL = 1e-5  # the kernel backend against the plain one

#: runs a reference example with runpy and prints, after its own output,
#: one JSON line of what it computed
_QUICKSTART = """
import json, runpy
g = runpy.run_path("examples/quickstart.py")
from repro.core import PageRank, plan
p = plan(PageRank(supersteps=10), g["graph"], g["budget"])
knobs = next(c for c in p.alternatives if c.chosen).knobs
print(json.dumps(dict(
    n_vertices=g["graph"].n_vertices, n_edges=g["graph"].n_edges,
    mode=p.mode, pipeline=p.pipeline, knobs=knobs,
    top=[[int(v), float(r)] for v, r in g["top"]],
    mass=float(sum(g["ranks"].values())),
    n_supersteps=g["s"]["n_supersteps"])))
"""
_ANALYTICS = """
import json, runpy
g = runpy.run_path("examples/graph_analytics.py")
p = g["job"].plan
knobs = next(c for c in p.alternatives if c.chosen).knobs
print(json.dumps(dict(
    n_vertices=g["graph"].n_vertices, n_edges=g["graph"].n_edges,
    mode=p.mode, pipeline=p.pipeline, knobs=knobs,
    pagerank_supersteps=g["res"].n_supersteps,
    final_delta=float(g["res"].history[-1].agg),
    values={str(k): float(v) for k, v in g["res"].values.items()},
    recovery_err=g["err"], components=g["comps"],
    hashmin_halt=int(g["r2"].history[-1].step),
    sssp_reached=g["reached"], sssp_supersteps=g["r3"].n_supersteps,
    expert_supersteps=len(g["hist"]))))
"""


def _reference(script):
    out = subprocess.run([sys.executable, "-c", script], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    *printed, last = out.stdout.strip().splitlines()
    return json.loads(last), printed


def _twin(module, capsys):
    got = module.main(["--device", "cpu"])
    return got, capsys.readouterr().out.strip().splitlines()


@pytest.fixture(scope="module")
def runs():
    """name -> (the twin's dict and lines, the reference's dict and lines),
    each run once."""
    cache = {}

    def get(name, capsys):
        if name not in cache:
            module, script = {"quickstart": (quickstart, _QUICKSTART),
                              "analytics": (graph_analytics, _ANALYTICS)}[name]
            cache[name] = (*_twin(module, capsys), *_reference(script))
        return cache[name]
    return get


def _same_plan(got, want):
    assert got["mode"] == want["mode"]
    assert got["pipeline"] == want["pipeline"]
    assert got["knobs"] == want["knobs"]


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------

def test_quickstart_graph_and_plan(runs, capsys):
    got, _, want, _ = runs("quickstart", capsys)
    assert (got["n_vertices"], got["n_edges"]) == (want["n_vertices"],
                                                   want["n_edges"])
    _same_plan(got, want)
    assert got["mode"] == "recoded"


def test_quickstart_ranks(runs, capsys):
    got, _, want, _ = runs("quickstart", capsys)
    assert [v for v, _ in got["top"]] == [v for v, _ in want["top"]]
    for vid, r in want["top"]:
        assert abs(got["values"][vid] - r) < PAGERANK_TOL, vid
    assert abs(got["mass"] - want["mass"]) < PAGERANK_TOL
    assert got["summary"]["n_supersteps"] == want["n_supersteps"] == 10


def test_quickstart_prints_the_reference_lines(runs, capsys):
    """Every line but the timed superstep lines and the plan's audit is
    the reference's, word for word."""
    _, lines, _, ref_lines = runs("quickstart", capsys)
    keep = ("graph:", "top-5", "  vertex", "rank mass", "mode=")
    pick = lambda ls: [x for x in ls if x.startswith(keep)]
    assert pick(lines) == pick(ref_lines)
    assert len(pick(lines)) == 9


# --------------------------------------------------------------------------
# graph_analytics
# --------------------------------------------------------------------------

def test_analytics_graph_and_plan(runs, capsys):
    got, _, want, _ = runs("analytics", capsys)
    assert (got["n_vertices"], got["n_edges"]) == (want["n_vertices"],
                                                   want["n_edges"])
    _same_plan(got, want)
    assert got["mode"] == "streamed"


def test_analytics_pagerank_and_recovery(runs, capsys):
    got, _, want, _ = runs("analytics", capsys)
    assert got["pagerank_supersteps"] == want["pagerank_supersteps"] == 9
    assert abs(got["final_delta"] - want["final_delta"]) < 1e-6
    keys = sorted(want["values"])
    gap = np.abs(np.array([got["values"][int(k)] for k in keys])
                 - np.array([want["values"][k] for k in keys])).max()
    assert gap < PAGERANK_TOL, gap
    assert got["recovery_err"] == want["recovery_err"] == 0.0


def test_analytics_hashmin_sssp_and_expert_path(runs, capsys):
    got, _, want, _ = runs("analytics", capsys)
    assert (got["components"], got["hashmin_halt"]) == (
        want["components"], want["hashmin_halt"]) == (1130, 4)
    assert (got["sssp_reached"], got["sssp_supersteps"]) == (
        want["sssp_reached"], want["sssp_supersteps"]) == (2966, 5)
    assert got["expert_supersteps"] == want["expert_supersteps"] == 5


def test_analytics_prints_the_reference_lines(runs, capsys):
    _, lines, _, ref_lines = runs("analytics", capsys)
    keep = ("graph:", "planned mode", "pagerank:", "fast recovery",
            "hash-min", "sssp:", "done.")
    pick = lambda ls: [x for x in ls if x.startswith(keep)]
    assert pick(lines) == pick(ref_lines)
    assert len(pick(lines)) == 7
    expert = [x for x in lines if x.startswith("expert path")]
    assert len(expert) == 1 and " 5 supersteps," in expert[0]


# --------------------------------------------------------------------------
# the device: CUDA unless asked
# --------------------------------------------------------------------------

@pytest.mark.parametrize("module", [quickstart, graph_analytics])
def test_twin_without_device_raises_without_cuda(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


@pytest.mark.parametrize("name", ["quickstart", "graph_analytics"])
def test_twin_cli_without_device_fails_without_cuda(name):
    """``python -m repro_torch.examples.<name>`` with no card visible and no
    ``--device``: it fails and says why, having printed nothing."""
    env = dict(ENV, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}"], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""
