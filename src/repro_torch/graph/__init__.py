"""Graph substrate: generation, CSR, ID recoding, partitioning.

``csr``, ``generate`` and ``recode`` are numpy-only copies of the JAX
package's modules (the port imports nothing of it); ``partition`` holds the
partition as a dataclass of torch tensors.
"""

from repro_torch.graph.csr import Graph, build_csr
from repro_torch.graph.generate import (
    chain_graph, erdos_renyi_graph, rmat_graph, star_graph,
)
from repro_torch.graph.partition import (
    PartitionedGraph, block_ranges, build_partition, drop_edges,
    partition_for_plan, partition_graph, partition_graph_streamed,
    spill_partition,
)
from repro_torch.graph.recode import RecodeMap, recode_ids

__all__ = [
    "Graph", "build_csr", "rmat_graph", "erdos_renyi_graph", "chain_graph",
    "star_graph", "RecodeMap", "recode_ids", "PartitionedGraph",
    "block_ranges", "build_partition", "partition_graph", "drop_edges",
    "partition_graph_streamed", "partition_for_plan", "spill_partition",
]
