"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
from repro_torch.kernels import fisher_merge, flash_attention, lora, ssd_scan

__all__ = ["fisher_merge", "flash_attention", "lora", "ssd_scan"]
