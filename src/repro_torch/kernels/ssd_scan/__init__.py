"""Mamba2 SSD chunked scan: ``ops.ssd`` (kernel wrapper) and ``ref`` (plain versions)."""
