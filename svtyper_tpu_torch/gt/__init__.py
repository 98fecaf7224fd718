"""Batched device genotyping engine on PyTorch."""

from svtyper_tpu_torch.gt.engine import TorchEngine  # noqa: F401
