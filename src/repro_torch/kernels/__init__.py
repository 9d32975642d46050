"""Hand-written Hopper kernels, each beside its plain PyTorch version: the
recoded superstep's ``edge_combine`` (CUDA C++, ``csrc/``) and ``digest``
(Triton), and ``run_sum`` (CUDA C++), the torch backend's float sums in
the CPU's order. ``build`` compiles the CUDA sources at first use."""
