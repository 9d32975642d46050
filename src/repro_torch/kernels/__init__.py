"""Hand-written Hopper kernels of the recoded superstep, each beside its
plain PyTorch version: ``edge_combine`` (CUDA C++, ``csrc/``) and ``digest``
(Triton). ``build`` compiles the CUDA sources at first use."""
