"""Device kernels (PyTorch + CUDA).

- ``gl``: batched Bayesian genotype-likelihood stage in torch (the
  float64 parity path, and the float32 reference).
- ``gl_kernel``: the fused float32 GL stage as a hand-written CUDA
  kernel (``csrc/gl_kernel.cu``) with its PyTorch-eager twin.
- ``classify_kernel``: the engine's classifier on the compact wire as a
  hand-written CUDA kernel (``csrc/classify_kernel.cu``) beside its
  plain version (``unwire`` → ``evidence/device.py::classify_compact``).
"""
