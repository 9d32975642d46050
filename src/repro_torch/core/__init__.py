"""Program API, algorithms, config, the in-memory superstep engine, and
its recovery layer (checkpoints, message logs, elastic rescale, mutation)."""

from repro_torch.core.algorithms import (
    BFS, SSSP, DegreeSum, DistinctInLabels, HashMin, LabelSpread, PageRank,
    SecondMinLabel,
)
from repro_torch.core.api import (
    IMAX, IMIN, MAX, MIN, SUM, Combiner, ShardContext, VertexProgram,
    keep_halted, segment_count_distinct, segment_second_min, segment_sum,
)
from repro_torch.core.checkpoint import Checkpointer, MessageLog, recover_shard
from repro_torch.core.config import ConfigError, EngineConfig
from repro_torch.core.elastic import extract_global, repartition
from repro_torch.core.engine import GraphDEngine, StepStats, SuperstepRecord
from repro_torch.core.mutation import mutate

__all__ = [
    "BFS", "SSSP", "DegreeSum", "DistinctInLabels", "HashMin", "LabelSpread",
    "PageRank", "SecondMinLabel",
    "IMAX", "IMIN", "MAX", "MIN", "SUM", "Combiner", "ShardContext",
    "VertexProgram", "keep_halted", "segment_count_distinct",
    "segment_second_min", "segment_sum",
    "Checkpointer", "MessageLog", "recover_shard",
    "ConfigError", "EngineConfig",
    "extract_global", "repartition",
    "GraphDEngine", "StepStats", "SuperstepRecord", "mutate",
]
