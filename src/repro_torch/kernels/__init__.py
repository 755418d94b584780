"""repro_torch.kernels — the hand-written Hopper kernels and their wrappers.

``csrc/*.cu`` are CUDA C++ sources built at first use by ``_build`` (nvcc,
``sm_90a``, plain C interface, ``ctypes``). Beside each kernel, in the same
module: a plain PyTorch version, a launch counter on the wrapper, and a note
on which TPU kernel it replaces and what bounds it on the card.

Ported: the pSRAM int8 matmul (``psram_matmul``) and the fused streaming
MTTKRP (``stream_mttkrp``). Still to come from the reference package: the
dense MTTKRP pair, the blocked segment sum, flash attention.
"""
