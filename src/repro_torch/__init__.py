"""repro_torch: the integral-histogram pipeline in PyTorch on an NVIDIA H100.

A port of the ``repro`` package (JAX on a TPU), which stays beside it as
the reference.  Same module layout and public names; the TPU's Pallas
kernels become hand-written CUDA kernels for ``sm_90a``
(``repro_torch/kernels/csrc``), built at first use.  Entry points run on
the GPU unless the caller passes ``device="cpu"``, where the plain torch
versions run.
"""

__version__ = "0.1.0"
