"""The port's dry-run GraphD cell (``repro_torch.launch.dryrun``, ``roofline``,
``perf``, ``report``) on the CPU, held against the JAX package: the
abstract partition's shape equals the reference's
``abstract_partitioned_graph`` (ShapeDtypeStructs only, no devices
needed), the useful-work terms equal the reference's ``roofline_terms``,
the record has the reference's keys, and the model's resident bytes equal
a real partition's tensors."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.graph.partition as ref_partition
import repro.launch.roofline as ref_roofline
import repro_torch.core as tc
from repro_torch.graph import (
    abstract_partitioned_graph, partition_graph, rmat_graph, shard_slice,
)
from repro_torch.launch import dryrun, perf, report, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE1 = {"clueweb": (978_408_098, 42_574_107_469),
          "webuk": (133_633_040, 5_507_679_822)}


def _ref_record_keys() -> set:
    """The keys of the reference's run_graphd_cell record: its return
    dict's literal keys and those of roofline_terms (``**terms``)."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "run_graphd_cell")
    ret = fn.body[-1]  # return dict(...), after the nested step()
    assert isinstance(ret, ast.Return) and ret.value.func.id == "dict"
    keys = {kw.arg for kw in ret.value.keywords if kw.arg is not None}
    terms = ref_roofline.roofline_terms(
        None, {}, flops=1.0, bytes_accessed=1.0, collective_bytes=1.0,
        n_chips=2, graphd=dict(V=4, E=8, n=2))
    return keys | set(terms)


# --------------------------------------------------------------------------
# the abstract partition against the reference's
# --------------------------------------------------------------------------

SMALL = [(2, 1000, 5000, 8, 1.5), (3, 7, 2, 128, 1.5), (5, 10**6, 10**7,
                                                        64, 2.0),
         (7, 99_991, 123_457, 32, 1.0), (16, 1, 0, 128, 1.5)]


@pytest.mark.parametrize("edge_block", [4096, 16384])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("scale", list(TABLE1))
def test_abstract_shape_equals_the_reference(scale, n, edge_block):
    V, E = TABLE1[scale]
    ref = ref_partition.abstract_partitioned_graph(n, V, E, edge_block,
                                                   vertex_pad=512)
    pg = abstract_partitioned_graph(n, V, E, edge_block, vertex_pad=512)
    assert (pg.P, pg.E_cap, pg.n_blocks) == (ref.P, ref.E_cap, ref.n_blocks)
    for f in pg.TENSORS:
        t, r = getattr(pg, f), getattr(ref, f)
        assert tuple(t.shape) == tuple(r.shape), f
        assert t.element_size() == np.dtype(r.dtype).itemsize, f
        assert t.device.type == "meta", f
    rec = dryrun.run_graphd_cell(n == 512, scale, edge_block=edge_block)
    assert (rec["P"], rec["E_cap"], rec["n_blocks"]) == \
        (ref.P, ref.E_cap, ref.n_blocks)


@pytest.mark.parametrize("n,V,E,pad,skew", SMALL)
def test_abstract_small_shapes_equal_the_reference(n, V, E, pad, skew):
    """The reference truncates E/n²·skew with int() before it rounds up,
    and keeps at least one pad and one block."""
    ref = ref_partition.abstract_partitioned_graph(n, V, E, 64, pad, skew)
    pg = abstract_partitioned_graph(n, V, E, 64, pad, skew)
    assert (pg.P, pg.E_cap, pg.n_blocks) == (ref.P, ref.E_cap, ref.n_blocks)


def test_clueweb_cells_as_published():
    """P, E_cap and blocks at n = 256 and 512, and the ring's (n-1)·P·8
    bytes a rank."""
    for multi, want in ((False, (3_822_080, 974_848, 238)),
                        (True, (1_911_296, 245_760, 60))):
        rec = dryrun.run_graphd_cell(multi)
        assert (rec["P"], rec["E_cap"], rec["n_blocks"]) == want
        n = 512 if multi else 256
        assert rec["collective_breakdown"] == dict(
            ring=(n - 1) * want[0] * 8, gather=4, reduce=40)
        assert rec["mesh"] == f"n{n}" and rec["ok"] and rec["fits"]


@pytest.mark.parametrize("n", [2, 64, 1024])
def test_n_overrides_the_machine_count(n):
    """``n=`` sets the ring's length in place of 256/512: the reference's
    abstract shape at that n, and (n-1)·P·8 bytes of ring a rank."""
    V, E = TABLE1["webuk"]
    ref = ref_partition.abstract_partitioned_graph(n, V, E, 4096,
                                                   vertex_pad=512)
    rec = dryrun.run_graphd_cell(True, "webuk", n=n)
    assert (rec["P"], rec["E_cap"], rec["n_blocks"], rec["mesh"]) == \
        (ref.P, ref.E_cap, ref.n_blocks, f"n{n}")
    assert rec["collective_breakdown"]["ring"] == (n - 1) * ref.P * 8


def test_dst_order_of_an_abstract_partition_refuses():
    pg = abstract_partitioned_graph(4, 1000, 10_000)
    with pytest.raises(ValueError, match="abstract"):
        pg.dst_order


class _Allocations(TorchDispatchMode):
    """Every tensor an op makes: (device type, bytes)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((t.device.type,
                                  t.numel() * t.element_size()))
        return out


@pytest.mark.parametrize("mode", dryrun.MODES)
def test_dry_run_allocates_nothing(mode):
    """Host arithmetic: the partition's tensors lie on meta, no tensor of
    more than a few KB is made on the CPU, none anywhere else; and, in a
    fresh process (this one's CUDA state depends on the tests run before),
    the card is never touched and no process group starts."""
    with _Allocations() as seen:
        recs = [dryrun.run_graphd_cell(multi, scale, mode)
                for multi in (False, True) for scale in TABLE1]
    assert {dev for dev, _ in seen.made} <= {"meta", "cpu"}
    assert max((b for dev, b in seen.made if dev == "cpu"), default=0) \
        <= 4096
    assert all(r["peak_bytes"] > r["argument_bytes"] > 0 for r in recs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    subprocess.run(
        [sys.executable, "-c",
         "import torch, torch.distributed as dist\n"
         "from repro_torch.launch import dryrun\n"
         "for multi in (False, True):\n"
         "    for scale in dryrun.SIZES:\n"
         f"        dryrun.run_graphd_cell(multi, scale, {mode!r})\n"
         "assert not torch.cuda.is_initialized()\n"
         "assert not dist.is_initialized()\n"],
        check=True, env=env,
    )


# --------------------------------------------------------------------------
# the record and the roofline against the reference
# --------------------------------------------------------------------------

def test_record_keys_are_the_references():
    want = (_ref_record_keys() - {"lower_s", "compile_s"}) \
        | {"P", "E_cap", "n_blocks", "fits"}
    for mode in dryrun.MODES:
        assert set(dryrun.run_graphd_cell(mode=mode)) == want


@pytest.mark.parametrize("link", [None, 1e11])
@pytest.mark.parametrize("mode", dryrun.MODES)
@pytest.mark.parametrize("multi,scale", [(False, "clueweb"),
                                         (True, "clueweb"),
                                         (False, "webuk")])
def test_useful_work_equals_the_references_roofline(multi, scale, mode,
                                                    link):
    """model_flops_per_chip and useful_flops_ratio are the reference's
    roofline_terms(graphd=...) on the same inputs; the three terms are the
    counts over the H100's rates; without a link rate the collective term
    is None and leaves dominant to the other two."""
    rec = dryrun.run_graphd_cell(multi, scale, mode, link_bytes_per_s=link)
    V, E = TABLE1[scale]
    n = 512 if multi else 256
    ref = ref_roofline.roofline_terms(
        None, dict(kind="graphd", seq_len=0, global_batch=0),
        flops=rec["flops_per_chip"], bytes_accessed=rec["bytes_per_chip"],
        collective_bytes=rec["collective_bytes_per_chip"], n_chips=n,
        graphd=dict(V=V, E=E, n=n))
    assert rec["model_flops_per_chip"] == ref["model_flops_per_chip"]
    assert rec["useful_flops_ratio"] == ref["useful_flops_ratio"]
    assert rec["t_memory_s"] == rec["bytes_per_chip"] / 3.35e12
    assert rec["t_compute_s"] == rec["flops_per_chip"] / 67e12
    if link is None:
        assert rec["t_collective_s"] is None
        assert rec["dominant"] in ("compute", "memory")
    else:
        assert rec["t_collective_s"] == \
            rec["collective_bytes_per_chip"] / link
        assert rec["dominant"] == "collective"  # the ring at 100 GB/s


def test_variants_differ_as_their_formulas_say():
    """C1: the compact wire (n·P·3 bytes of all_to_all, no ring) on the
    torch backend (dst_order resident); C2: 16384-slot blocks (E_cap
    rounded to them, a quarter of the blocks or fewer, the same wire);
    C3: both. P never moves."""
    base = dryrun.run_graphd_cell()
    c1, c2, c3 = (perf.variant_C(t) for t in ("C1", "C2", "C3"))
    n, P, V, E = 256, base["P"], *TABLE1["clueweb"]
    assert [r["variant"] for r in (c1, c2, c3)] == ["C1", "C2", "C3"]
    assert all(r["P"] == P for r in (c1, c2, c3))
    assert c1["collective_breakdown"] == dict(all_to_all=n * P * 3, gather=4,
                                              reduce=40)
    assert (c1["E_cap"], c1["n_blocks"]) == (base["E_cap"],
                                             base["n_blocks"])
    assert c1["argument_bytes"] - base["argument_bytes"] == \
        4 * n * base["E_cap"]  # dst_order
    cap = max(-(-int(E / n**2 * 1.5) // 16384) * 16384, 16384)
    assert (c2["E_cap"], c2["n_blocks"]) == (cap, cap // 16384)
    assert c2["collective_breakdown"] == base["collective_breakdown"]
    assert c2["argument_bytes"] - base["argument_bytes"] == \
        12 * n * (cap - base["E_cap"]) \
        + 8 * n * (cap // 16384 - base["n_blocks"])
    assert c3["collective_breakdown"] == c1["collective_breakdown"]
    assert (c3["E_cap"], c3["n_blocks"]) == (c2["E_cap"], c2["n_blocks"])
    with pytest.raises(KeyError):
        perf.variant_C("C4")


def test_byte_model_by_mode():
    """superstep_bytes: each mode's formula, the staged bytes under gloo on
    the card, nothing at one rank."""
    n, P, E_cap = 8, 1000, 4096
    want = dict(recoded=((n - 1) * P * 8, 0), basic_sc=((n - 1) * P * 8, 0),
                basic=(0, n * E_cap * 8), recoded_compact=(0, n * P * 3),
                logged=(0, n * P * 8))
    for mode, (ring, a2a) in want.items():
        got = dryrun.superstep_bytes(mode, n, P, E_cap)
        assert got == dict(ring=ring, all_to_all=a2a, gather=4, reduce=40,
                           staged=0)
        gloo = dryrun.superstep_bytes(mode, n, P, E_cap, gather=0,
                                      staged=True)
        assert gloo["staged"] == 2 * (ring + a2a) + 80 and gloo["gather"] == 0
    assert dryrun.superstep_bytes("basic", 1, P, E_cap)["all_to_all"] == 0
    with pytest.raises(ValueError, match="mode"):
        dryrun.superstep_bytes("streamed", n, P, E_cap)


# --------------------------------------------------------------------------
# the model against a real partition's tensors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale,n,edge_block", [(8, 2, 64), (9, 4, 128),
                                                (10, 8, 256)])
def test_resident_bytes_equal_a_real_partition(scale, n, edge_block):
    """The model's partition bytes, times the rows held, are the nine
    tensors' numel·element_size; dst_order's, once built, its own; the
    state's, the engine's initial values and bitmap; a rank's slice gives
    the same record as the whole partition."""
    g = rmat_graph(scale=scale, edge_factor=8, seed=scale, weights="uniform")
    pg, _ = partition_graph(g, n, edge_block=edge_block, device="cpu")
    model = dryrun.resident_bytes(n, pg.P, pg.E_cap, pg.n_blocks,
                                  dst_order=True)
    got = dryrun.partition_tensor_bytes(pg)
    assert got == dict(partition=n * model["partition"], dst_order=0)
    pg.dst_order  # built at first use, by the torch backend's dense groups
    got = dryrun.partition_tensor_bytes(pg)
    assert got["dst_order"] == n * model["dst_order"]
    values, active = tc.GraphDEngine(pg, tc.PageRank(1), device="cpu").init()
    assert values.numel() * values.element_size() \
        + active.numel() * active.element_size() == n * model["state"]
    for mode, backend in (("recoded", "kernel"), ("recoded", "torch"),
                          ("recoded_compact", "torch"), ("basic", "torch"),
                          ("basic_sc", "torch")):
        rec = dryrun.run_graphd_cell(mode=mode, pg=pg, backend=backend)
        built = dryrun.builds_dst_order(mode, backend)
        assert rec["argument_bytes"] == model["partition"] \
            + model["state"] + (model["dst_order"] if built else 0)
        one = dryrun.run_graphd_cell(mode=mode, backend=backend,
                                     pg=shard_slice(pg, n - 1))
        assert one == rec
        assert (rec["P"], rec["E_cap"], rec["n_blocks"], rec["edge_block"]) \
            == (pg.P, pg.E_cap, pg.n_blocks, edge_block)


def test_dst_order_is_built_where_the_model_says(tmp_path):
    """A PageRank run on the CPU builds dst_order exactly where
    builds_dst_order says so."""
    g = rmat_graph(scale=8, edge_factor=8, seed=1, weights="uniform")
    for mode, backend in (("recoded", "kernel"), ("recoded", "torch"),
                          ("recoded_compact", "torch"), ("basic", "torch"),
                          ("basic_sc", "torch")):
        pg, _ = partition_graph(g, 4, edge_block=64, device="cpu")
        tc.GraphDEngine(pg, tc.PageRank(2), tc.EngineConfig(
            mode=mode, backend=backend), device="cpu").run()
        assert ("dst_order" in pg.__dict__) == \
            dryrun.builds_dst_order(mode, backend), (mode, backend)


def test_backend_must_run_the_mode():
    with pytest.raises(ValueError, match="backend"):
        dryrun.run_graphd_cell(mode="basic", backend="kernel")
    with pytest.raises(ValueError, match="mode"):
        dryrun.run_graphd_cell(mode="streamed")
    with pytest.raises(ValueError, match="scale"):
        dryrun.run_graphd_cell(scale="twitter")


# --------------------------------------------------------------------------
# the command lines and the report
# --------------------------------------------------------------------------

def test_cli_writes_and_prints_the_records(tmp_path, capsys):
    out = str(tmp_path / "d.json")
    assert dryrun.main(["--graphd", "--out", out]) == 0
    assert dryrun.main(["--graphd", "--multipod", "--out", out]) == 0
    assert dryrun.main(["--graphd", "--out", out]) == 0  # replaces its own
    text = capsys.readouterr().out
    assert "P 3822080, E_cap 974848, 238 blocks" in text
    assert "P 1911296, E_cap 245760, 60 blocks" in text
    assert f"(ring {255 * 3822080 * 8}, gather 4, reduce 40)" in text
    assert f"dst_order {4 * 256 * 974848}" in text
    with open(out) as fh:
        recs = json.load(fh)
    assert sorted(r["mesh"] for r in recs) == ["n256", "n512"]
    table = report.dryrun_table(recs) + report.roofline_table(recs)
    assert "graphd-pagerank-clueweb" in table and "| – |" in table
    assert perf.main(["C1", "C3", "--link-bytes-per-s", "2e11", "--out",
                      str(tmp_path / "p.json")]) == 0
    with open(tmp_path / "p.json") as fh:
        assert [r["variant"] for r in json.load(fh)] == ["C1", "C3"]
