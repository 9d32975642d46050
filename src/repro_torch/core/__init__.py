"""Program API, algorithms, config and the recoded superstep engine."""

from repro_torch.core.algorithms import (
    BFS, SSSP, DegreeSum, HashMin, LabelSpread, PageRank,
)
from repro_torch.core.api import (
    IMAX, IMIN, MAX, MIN, SUM, Combiner, ShardContext, VertexProgram,
    keep_halted,
)
from repro_torch.core.config import ConfigError, EngineConfig
from repro_torch.core.engine import GraphDEngine, StepStats, SuperstepRecord

__all__ = [
    "BFS", "SSSP", "DegreeSum", "HashMin", "LabelSpread", "PageRank",
    "IMAX", "IMIN", "MAX", "MIN", "SUM", "Combiner", "ShardContext",
    "VertexProgram", "keep_halted", "ConfigError", "EngineConfig",
    "GraphDEngine", "StepStats", "SuperstepRecord",
]
