"""DECA on PyTorch and CUDA: the port of `repro` to an NVIDIA H100.

Compressed-weight paged serving of a dense GQA decoder. FC weights live in
the DECA {codes, mask, scales} triplet (`core/compression.py`); every FC
matmul and every decode-attention step runs through a CUDA kernel written
for Hopper (`kernels/`, sources in `csrc/`) that decodes the compressed
stream in shared memory or registers right before it is used, so no dense
weight and no dense KV view is ever written to device memory.

Entry points (`models.model.Model`, `serve.engine.GenerationEngine`,
`core.decompress.compress_tree`) run on the card unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper takes its plain PyTorch
version (`kernels/ref.py`). This package imports torch, numpy and the
standard library only.
"""
