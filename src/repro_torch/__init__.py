"""FedNano in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

Same module layout and names as ``repro``; imports neither JAX nor ``repro``.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
