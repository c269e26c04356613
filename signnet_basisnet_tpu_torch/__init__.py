"""signnet_basisnet_tpu_torch — the PyTorch/CUDA port of signnet_basisnet_tpu.

The JAX package beside it is the reference; this package mirrors its layout
(graph, spectral, data, nn, models, ops, training, train_zinc) module by
module, in PyTorch idiom, and imports no JAX.  Every Pallas kernel on a
ported path becomes a hand-written CUDA kernel for Hopper (sm_90a) under
`ops/csrc/`, built with nvcc at first use and bound with ctypes; each kernel
keeps a plain-PyTorch version beside it, which is the only path for CPU
tensors.

Ported so far: the ZINC trainer with its five nets and PEs, with every
Pallas kernel of the JAX package as a CUDA kernel (ops/); the Alchemy,
GINE-ZINC and LearningFilters (BasisNet, the spectral-filter nets)
trainers; and the benchmark entry points bench_ops, bench (with the train
step captured in a CUDA graph) and bench_roofline.  See ROADMAP.md for
the rest.
"""

__version__ = "0.1.0"
