"""Hand-written Hopper kernels of the port, with their plain versions.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs the plain
PyTorch version only on a CPU tensor.  Kernels are built with ``nvcc`` at
first use (see :mod:`repro_torch.kernels._build`), never at import.  The
three kernels: the Pearson Gram (``pearson_affinity``), flash attention
(``flash_attention``) and the Mamba2 SSD scan (``ssd_scan``, reached as
``ops.ssd_scan``: the submodule keeps its name here).
"""
from repro_torch.kernels.ops import flash_attention_bhsd, pairwise_pearson_dissimilarity
from repro_torch.kernels.pearson_affinity import pearson_dissimilarity
