"""Program API, algorithms, config, the superstep engine (the in-memory
modes and the out-of-core ``streamed`` mode), the planner, the job facade,
and the recovery layer (checkpoints, message logs, elastic rescale,
mutation).

The public names are re-exported LAZILY (PEP 562), as ``repro.core`` does:
importing a light submodule (``repro_torch.core.coordinator`` in
particular) must not pay for the engine's torch import. A worker process of
the multi-process launch imports the coordinator and starts its liveness
heartbeat *before* any heavy import; an eager package ``__init__`` would
put the load of libtorch in front of its first beat.
"""

#: public name -> submodule that defines it (resolved on first attribute
#: access; ``from repro_torch.core import X`` goes through __getattr__ too)
_EXPORTS = {
    name: mod
    for mod, names in {
        "algorithms": ("BFS", "SSSP", "DegreeSum", "DistinctInLabels",
                       "HashMin", "LabelSpread", "PageRank",
                       "SecondMinLabel"),
        "api": ("IMAX", "IMIN", "MAX", "MIN", "SUM", "Combiner",
                "ShardContext", "VertexProgram", "keep_halted",
                "segment_count_distinct", "segment_second_min",
                "segment_sum"),
        "checkpoint": ("Checkpointer", "MessageLog", "RunFileMessageLog",
                       "recover_shard", "recover_shard_streamed"),
        "config": ("ChannelConfig", "ConfigError", "EngineConfig",
                   "MessageSpillConfig", "RecoveryConfig", "StreamConfig"),
        "elastic": ("extract_global", "repartition"),
        "engine": ("GraphDEngine", "StepStats", "StreamKernels",
                   "SuperstepRecord"),
        "job": ("GraphDJob", "JobResult"),
        "mutation": ("mutate",),
        "plan": ("ExecutionPlan", "GraphMeta", "MemoryBudget",
                 "PlanInfeasible", "estimate_memory"),
    }.items()
    for name in names
}

# ``plan`` the FUNCTION collides with ``plan`` the submodule: whenever the
# submodule is (transitively) imported, the import machinery binds the
# module object as a package attribute, which would shadow the lazy export
# and never let __getattr__ fire. Bind the function eagerly instead (the
# submodule imports numpy and no torch, so worker startup stays light);
# later submodule imports find it in sys.modules and leave this binding be.
from repro_torch.core.plan import plan  # noqa: E402

__all__ = [
    "BFS", "SSSP", "DegreeSum", "DistinctInLabels", "HashMin", "LabelSpread",
    "PageRank", "SecondMinLabel",
    "IMAX", "IMIN", "MAX", "MIN", "SUM", "Combiner", "ShardContext",
    "VertexProgram", "keep_halted", "segment_count_distinct",
    "segment_second_min", "segment_sum",
    "Checkpointer", "MessageLog", "RunFileMessageLog", "recover_shard",
    "recover_shard_streamed",
    "ChannelConfig", "ConfigError", "EngineConfig", "MessageSpillConfig",
    "RecoveryConfig", "StreamConfig",
    "extract_global", "repartition",
    "GraphDEngine", "StepStats", "StreamKernels", "SuperstepRecord",
    "GraphDJob", "JobResult", "mutate",
    "ExecutionPlan", "GraphMeta", "MemoryBudget", "PlanInfeasible",
    "estimate_memory", "plan",
]


def __getattr__(name):
    import importlib

    mod = _EXPORTS.get(name)
    if mod is not None:
        value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
        globals()[name] = value  # cache: __getattr__ runs once per name
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
