"""Program API, algorithms, config, the superstep engine (the in-memory
modes and the out-of-core ``streamed`` mode), the planner, the job facade,
and the recovery layer (checkpoints, message logs, elastic rescale,
mutation)."""

from repro_torch.core.algorithms import (
    BFS, SSSP, DegreeSum, DistinctInLabels, HashMin, LabelSpread, PageRank,
    SecondMinLabel,
)
from repro_torch.core.api import (
    IMAX, IMIN, MAX, MIN, SUM, Combiner, ShardContext, VertexProgram,
    keep_halted, segment_count_distinct, segment_second_min, segment_sum,
)
from repro_torch.core.checkpoint import (
    Checkpointer, MessageLog, RunFileMessageLog, recover_shard,
    recover_shard_streamed,
)
from repro_torch.core.config import (
    ChannelConfig, ConfigError, EngineConfig, MessageSpillConfig,
    RecoveryConfig, StreamConfig,
)
from repro_torch.core.elastic import extract_global, repartition
from repro_torch.core.engine import (
    GraphDEngine, StepStats, StreamKernels, SuperstepRecord,
)
from repro_torch.core.job import GraphDJob, JobResult
from repro_torch.core.mutation import mutate
from repro_torch.core.plan import (
    ExecutionPlan, GraphMeta, MemoryBudget, PlanInfeasible, estimate_memory,
    plan,
)

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
