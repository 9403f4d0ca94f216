"""pointtinybenchmark_tpu_torch: the PyTorch/CUDA port of
pointtinybenchmark_tpu, laid out like it. Plain tensor code is PyTorch; the
JAX package's Pallas kernels become kernels written for NVIDIA Hopper
(ops/csrc). This package imports neither jax nor the JAX package."""
