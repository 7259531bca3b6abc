"""PyTorch / CUDA port of pcc_tpu, the learned point-cloud geometry codec.

The package runs the compress -> decompress path and the train step of the
IPDAE and PPPF-AE families on an NVIDIA H100 (sm_90a) with hand-written
CUDA kernels for farthest point sampling, the fused patch encoder and its
backward, the fused patch decoder and the fused PN++ set-abstraction stage
and its backward (csrc/), and on the CPU with their plain PyTorch
versions. It imports torch, numpy and the
standard library only; pcc_tpu (JAX) stays the reference it is tested
against.
"""
