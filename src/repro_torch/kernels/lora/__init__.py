"""NanoAdapter (LoRA) residual kernels."""
