"""signnet_basisnet_tpu_torch — the PyTorch/CUDA port of signnet_basisnet_tpu.

The JAX package beside it is the reference; this package mirrors its layout
(graph, spectral, data, nn, models, ops, training, train_zinc) module by
module, in PyTorch idiom, and imports no JAX.  Every Pallas kernel on a
ported path becomes a hand-written CUDA kernel for Hopper (sm_90a) under
`ops/csrc/`, built with nvcc at first use and bound with ctypes; each kernel
keeps a plain-PyTorch version beside it, which is the only path for CPU
tensors.

Ported so far: the ZINC GIN + SignNet (GINDeepSigns) trainer with the
tile-local SpMM kernel (ops/spmm_tiled.py).  See ROADMAP.md for the rest.
"""

__version__ = "0.1.0"
