"""PyTorch / CUDA port of pcc_tpu, the learned point-cloud geometry codec.

The package runs the IPDAE compress -> decompress path and the IPDAE train
step on an NVIDIA H100 (sm_90a) with hand-written CUDA kernels for
farthest point sampling, the fused patch encoder and its backward, and the
fused patch decoder (csrc/), and on the CPU with their plain PyTorch
versions. It imports torch, numpy and the
standard library only; pcc_tpu (JAX) stays the reference it is tested
against.
"""
