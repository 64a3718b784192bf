"""Hand-written Hopper kernels of the port, with their plain versions.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs the plain
PyTorch version only on a CPU tensor.  Kernels are built with ``nvcc`` at
first use (see :mod:`repro_torch.kernels._build`), never at import.
"""
from repro_torch.kernels.ops import pairwise_pearson_dissimilarity
from repro_torch.kernels.pearson_affinity import pearson_dissimilarity
