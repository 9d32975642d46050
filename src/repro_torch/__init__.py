"""GraphD on PyTorch and CUDA: the port of the ``repro`` package (JAX/Pallas
on a TPU) to one NVIDIA H100.

``repro`` stays as the reference; this package imports nothing of it nor of
``jax``, and keeps its own copies of the numpy-only modules it needs. Its
entry points (``graph.partition_graph``, ``core.GraphDEngine``) run on CUDA
unless given ``device="cpu"``.
"""
