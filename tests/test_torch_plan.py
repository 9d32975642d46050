"""The port's planner and job facade against the JAX package's, on the CPU:
``plan()`` over a grid of budgets and programs picks the reference's mode
and every knob, ``estimate_memory`` gives equal dicts, a threads job's
``JobResult.summary()`` equals the reference's apart from the seconds, and
what the port has not reached yet (the multi-process launch, the socket link
probe) names the slice that brings it."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.graph import rmat_graph as ref_rmat
from repro_torch.graph import rmat_graph

# the modules (both packages export a function of the same name)
ref_plan = importlib.import_module("repro.core.plan")
port_plan = importlib.import_module("repro_torch.core.plan")

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

N = 3
EDGE_BLOCK = 32
PROGRAMS = {
    "pagerank": (lambda: rc.PageRank(3), lambda: tc.PageRank(3)),
    "hashmin": (rc.HashMin, tc.HashMin),
    "distinct": (lambda: rc.DistinctInLabels(n_groups=8, rounds=2),
                 lambda: tc.DistinctInLabels(n_groups=8, rounds=2)),
}


@pytest.fixture(scope="module")
def graphs():
    return (ref_rmat(scale=10, edge_factor=8, seed=5),
            rmat_graph(scale=10, edge_factor=8, seed=5))


def _floor(g_ref, prog, pipeline):
    """RAM of the streamed candidate at the planner's floor knobs
    (tests/test_plan.py's ``_floors``), with the plan's own geometry
    estimate."""
    P = max((-(-g_ref.n_vertices // N) + 7) // 8 * 8, 8)
    E_cap = max(int(g_ref.n_edges / (N * N) * 1.5 + EDGE_BLOCK - 1)
                // EDGE_BLOCK * EDGE_BLOCK, EDGE_BLOCK)
    return ref_plan.ram_total(ref_plan.estimate_memory(
        mode="streamed", n_shards=N, P=P, E_cap=E_cap, edge_block=EDGE_BLOCK,
        value_itemsize=4, msg_itemsize=4,
        combined=prog.combiner is not None, chunk_blocks=1, slice_cap=128,
        read_chunk=64, merge_fanin=2, inflight=1, group_batch=1,
        pipeline=pipeline, full_duplex=False), "streamed")


def _budgets(g_ref, prog):
    """Budgets that walk every branch of the planner for ``prog``: none,
    just under the in-memory mode (streamed, with a hot cache sized from
    the rest), the streamed and pipelined floors, a disk budget that
    engages the codecs, a net budget for the wire codecs, and one that fits
    nothing."""
    loose = ref_plan.plan(prog, g_ref, rc.MemoryBudget(n_shards=N),
                          edge_block=EDGE_BLOCK)
    first = loose.alternatives[0]
    ram = _floor(g_ref, prog, False)
    base = ref_plan.plan(prog, g_ref, rc.MemoryBudget(ram_per_shard=ram + 8192,
                                                      n_shards=N),
                         edge_block=EDGE_BLOCK)
    return {
        "unbounded": dict(),
        "below_in_memory": dict(ram_per_shard=first.ram_total - 1),
        "streamed_floor": dict(ram_per_shard=ram),
        "pipeline_floor": dict(ram_per_shard=_floor(g_ref, prog, True)),
        "disk": dict(ram_per_shard=ram + 8192,
                     disk_per_shard=int(base.disk_total * 0.8)),
        "net": dict(ram_per_shard=ram + 8192,
                    net_per_superstep=base.net_total - 1),
        "tiny": dict(ram_per_shard=64),
    }


def _plan_facts(p):
    """Everything a plan decides, in package-neutral form."""
    cfg = p.config
    return dict(
        mode=p.mode, pipeline=p.pipeline, compress=p.compress,
        compress_payload=p.compress_payload, n_shards=p.n_shards,
        edge_block=p.edge_block, vertex_pad=p.vertex_pad, model=p.model,
        ram_total=p.ram_total, disk_total=p.disk_total,
        net_total=p.net_total, launch=p.launch,
        stream=dataclasses.asdict(cfg.stream),
        spill=dataclasses.asdict(cfg.spill),
        channel={k: v for k, v in dataclasses.asdict(cfg.channel).items()},
        recovery=dataclasses.asdict(cfg.recovery),
        alternatives=[c.to_json() for c in p.alternatives],
        explain=_reference_explain(p),
    )


STAGER_LINE = "port host RAM outside this model: fold stager "


def _reference_explain(p):
    """``p.explain()`` without the line only the port's plans carry: the
    streamed engine's fold stager, which must be named (with its size)
    exactly when the plan is streamed."""
    lines = p.explain().split("\n")
    if p.__class__.__module__.startswith("repro."):
        return lines
    extra = [ln for ln in lines if ln.startswith(STAGER_LINE)]
    if p.mode == "streamed":
        st = p.config.stream
        assert extra == [STAGER_LINE + port_plan._fmt(
            port_plan.fold_stager_bytes(st.chunk_blocks, st.group_batch,
                                        p.edge_block)) + " a process"]
    else:
        assert extra == []
    return [ln for ln in lines if ln not in extra]


@pytest.mark.parametrize("launch", ["threads", "processes"])
@pytest.mark.parametrize("budget", ["unbounded", "below_in_memory",
                                    "streamed_floor", "pipeline_floor",
                                    "disk", "net", "tiny"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_plan_matches_reference(graphs, name, budget, launch):
    g_ref, g = graphs
    ref_prog, port_prog = (f() for f in PROGRAMS[name])
    kw = dict(_budgets(g_ref, ref_prog)[budget], n_shards=N)
    try:
        want = ref_plan.plan(ref_prog, g_ref, rc.MemoryBudget(**kw),
                             edge_block=EDGE_BLOCK, launch=launch)
    except ref_plan.PlanInfeasible as e:
        with pytest.raises(port_plan.PlanInfeasible) as got:
            port_plan.plan(port_prog, g, tc.MemoryBudget(**kw),
                           edge_block=EDGE_BLOCK, launch=launch)
        assert str(got.value) == str(e) and got.value.breakdown == e.breakdown
        return
    got = port_plan.plan(port_prog, g, tc.MemoryBudget(**kw),
                         edge_block=EDGE_BLOCK, launch=launch)
    assert _plan_facts(got) == _plan_facts(want)
    # the port's recoded runs on its default backend, the kernels
    assert got.config.backend == ("kernel" if got.mode == "recoded"
                                  else "torch")


def test_budget_grid_reaches_every_mode(graphs):
    """The grid above is not degenerate: it reaches the in-memory modes,
    plain and pipelined streaming, both codecs, and infeasibility."""
    g_ref, _ = graphs
    seen = set()
    for name, (ref_f, _) in PROGRAMS.items():
        for kw in _budgets(g_ref, ref_f()).values():
            try:
                p = ref_plan.plan(ref_f(), g_ref,
                                  rc.MemoryBudget(n_shards=N, **kw),
                                  edge_block=EDGE_BLOCK)
            except ref_plan.PlanInfeasible:
                seen.add("infeasible")
                continue
            seen.add(next(c.name for c in p.alternatives if c.chosen))
            seen.add(f"cache={bool(p.config.stream.cache_bytes)}")
    for want in ("recoded", "basic", "streamed", "infeasible",
                 "cache=True"):
        assert any(s.startswith(want) for s in seen), (want, seen)
    assert any("+pipeline" in s for s in seen), seen
    assert any("+compress" in s for s in seen), seen


ESTIMATE_GRID = [
    dict(mode=m, combined=c, pipeline=p, compress=z, compress_payload=cp,
         full_duplex=fd, group_batch=gb, cache_bytes=cb)
    for m in ("recoded", "basic", "streamed")
    for c in (True, False) for p in (False, True)
    for z, cp in ((False, False), (True, "lossless"))
    for fd in (True, False) for gb in (1, 4) for cb in (0, 1 << 20)
    if m == "streamed" or not (p or z or cb)
]


@pytest.mark.parametrize("chunk_blocks,depth", [(8, 2), (1, 1), (256, 3)])
def test_estimate_memory_matches_reference(chunk_blocks, depth):
    geom = dict(n_shards=8, P=2_100_072, E_cap=4_203_008, edge_block=512,
                value_itemsize=4, msg_itemsize=4, chunk_blocks=chunk_blocks,
                depth=depth)
    for kw in ESTIMATE_GRID:
        got = port_plan.estimate_memory(**geom, **kw)
        want = ref_plan.estimate_memory(**geom, **kw)
        assert got == want, kw
        assert (port_plan.ram_total(got, kw["mode"])
                == ref_plan.ram_total(want, kw["mode"]))
    for mode in ("recoded", "recoded_compact", "basic", "basic_sc",
                 "streamed"):
        for c in (True, False):
            a = dict(n_shards=8, P=1000, E_cap=4096, msg_itemsize=4,
                     combined=c, compress=True, compress_payload="lossless")
            assert (port_plan.estimate_net(mode, **a)
                    == ref_plan.estimate_net(mode, **a))


def _summary(res):
    s = res.summary()
    for r in s["history"]:
        del r["seconds"]
    return s


def _streamed_budget(ref_prog, g_ref):
    loose = ref_plan.plan(ref_prog, g_ref, rc.MemoryBudget(n_shards=N),
                          edge_block=EDGE_BLOCK)
    return dict(ram_per_shard=loose.alternatives[0].ram_total - 1,
                n_shards=N)


@pytest.mark.parametrize("budget", ["in_memory", "streamed"])
@pytest.mark.parametrize("name", ["hashmin", "distinct"])
def test_job_summary_matches_reference(graphs, tmp_path, name, budget):
    """A threads job under the same budget: the same plan, values,
    superstep history (residency counters included) and planned/realized
    memory model as the JAX package's job."""
    g_ref, g = graphs
    ref_f, port_f = PROGRAMS[name]
    kw = (dict(n_shards=N) if budget == "in_memory"
          else _streamed_budget(ref_f(), g_ref))
    with rc.GraphDJob(ref_f(), g_ref, budget=rc.MemoryBudget(**kw),
                      edge_block=EDGE_BLOCK,
                      workdir=str(tmp_path / "ref")) as job:
        want = job.run()
    with tc.GraphDJob(port_f(), g, budget=tc.MemoryBudget(**kw),
                      edge_block=EDGE_BLOCK, workdir=str(tmp_path / "port"),
                      device="cpu") as job:
        assert job.plan.mode == want.plan.mode
        got = job.run()
    assert _summary(got) == _summary(want)
    assert got.values == want.values


def test_job_streamed_recover_and_rescale_match_reference(graphs, tmp_path):
    """Single-shard recovery and a 3 -> 4 rescale of a streamed threads
    job, each against the JAX package's job."""
    g_ref, g = graphs
    kw = _streamed_budget(rc.HashMin(), g_ref)
    out = {}
    for pkg, graph, extra in ((rc, g_ref, {}), (tc, g, dict(device="cpu"))):
        with pkg.GraphDJob(pkg.HashMin(), graph,
                           budget=pkg.MemoryBudget(**kw),
                           edge_block=EDGE_BLOCK, checkpoint_every=2,
                           workdir=str(tmp_path / pkg.__name__),
                           **extra) as job:
            assert job.plan.mode == "streamed"
            job.run(max_supersteps=3)
            rec = [np.asarray(x) for x in job.recover_shard(1)]
            res = job.rescale(4).run()
            out[pkg] = (rec, res.values, _summary(res)["history"])
    (rv, ra), rvals, rhist = out[rc]
    (pv, pa), pvals, phist = out[tc]
    assert np.array_equal(pv, rv) and np.array_equal(pa, ra)
    assert pvals == rvals and phist == rhist


def test_later_slice_entry_points_name_slice_4(graphs):
    """The entry points slice 4b brought: the measured link probe returns
    a positive rate through the socket frame path, and a sockets job
    builds; bad launch names and launch_opts beside threads still raise."""
    g_ref, g = graphs
    assert port_plan.measured_link_throughput(n_bytes=1 << 20) > 0
    with tc.GraphDJob(tc.HashMin(), g, launch="processes", device="cpu",
                      launch_opts={"transport": "sockets"}) as job:
        assert job.plan.mode == "streamed"
        assert job.launch_opts == {"transport": "sockets"}
    with pytest.raises(ValueError, match="launch must be"):
        tc.GraphDJob(tc.HashMin(), g, launch="nope", device="cpu")
    with pytest.raises(tc.ConfigError, match="launch_opts apply"):
        tc.GraphDJob(tc.HashMin(), g, launch_opts={"transport": "files"},
                     device="cpu")


def test_job_defaults_to_the_card(graphs):
    _, g = graphs
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.GraphDJob(tc.HashMin(), g, budget=tc.MemoryBudget(n_shards=N))
