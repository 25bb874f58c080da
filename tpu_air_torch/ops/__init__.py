"""tpu_air_torch.ops — hand-written CUDA kernels for Hopper, each beside its
plain PyTorch version.  Kernels are built from ``ops/csrc`` at first use."""
