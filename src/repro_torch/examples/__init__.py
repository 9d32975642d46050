"""The GraphD examples on the port: ``quickstart`` (PageRank through the
declarative job API) and ``graph_analytics`` (the whole job lifecycle:
checkpoints and message logs, single-shard recovery, an elastic rescale,
SSSP, and the raw engine in full-duplex ``streamed``).

Each runs on CUDA unless asked for the CPU, and its ``main(argv)`` returns
what it printed::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.graph_analytics [--device cpu]
"""
