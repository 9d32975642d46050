"""Deployment launchers: run a planned GraphD job as real OS processes.

``launch="threads"`` emulates the paper's cluster inside one process. This
package is the other half of the claim:
:func:`repro_torch.launch.procs.run_processes` starts ONE WORKER PROCESS PER
SHARD, each opening only its owner view of the edge store, exchanging
messages through the shared-filesystem run-file transport and synchronizing
through the file-based coordinator barriers.
"""

__all__ = ["run_processes"]


def __getattr__(name):
    # lazy (PEP 562): ``python -m repro_torch.launch.procs``, the worker
    # entry, executes this package __init__ first; an eager procs import
    # here would double-execute the module under runpy and slow startup
    if name == "run_processes":
        from repro_torch.launch.procs import run_processes

        return run_processes
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
