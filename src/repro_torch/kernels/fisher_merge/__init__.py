"""Fisher-weighted merge kernels (paper Eq. 1)."""
