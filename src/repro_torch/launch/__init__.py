"""Deployment launchers: run a planned GraphD job as real OS processes.

``launch="threads"`` emulates the paper's cluster inside one process. This
package is the other half of the claim:
:func:`repro_torch.launch.procs.run_processes` starts ONE WORKER PROCESS PER
SHARD, each opening only its owner view of the edge store, exchanging
messages through the shared-filesystem run-file transport and synchronizing
through the file-based coordinator barriers, or, with
``launch_opts={"transport": "sockets"}``, over loopback TCP
(:mod:`repro_torch.launch.net`) with a coordinator process of its own.
:func:`repro_torch.launch.mesh.run_mesh` runs the in-memory engine as a
mesh over ``torch.distributed``, one process a shard (gloo on the CPU,
NCCL with one GPU a rank). :mod:`repro_torch.launch.dryrun` prices the
paper's GraphD cell a GPU of such a mesh from the partition's shape alone.
"""

#: the socket transport's public names, all in ``repro_torch.launch.net``
_NET = ("CoordClient", "CoordServer", "FrameError", "PeerSender",
        "PeerServer", "TornFrame", "decode_run", "encode_run",
        "probe_file_throughput", "probe_link_throughput", "recv_frame",
        "send_frame")

#: the mesh launcher's public names, all in ``repro_torch.launch.mesh``
_MESH = ("CaseFiles", "MeshFailed", "MeshResult", "MeshRun", "run_mesh",
         "run_mesh_cases")

__all__ = ["run_processes", *_NET, *_MESH]


def __getattr__(name):
    # lazy (PEP 562): ``python -m repro_torch.launch.procs``, the worker
    # entry, executes this package __init__ first; an eager procs import
    # here would double-execute the module under runpy and slow startup
    if name == "run_processes":
        from repro_torch.launch.procs import run_processes

        return run_processes
    if name in _NET:
        from repro_torch.launch import net

        return getattr(net, name)
    if name in _MESH:
        from repro_torch.launch import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
