"""The JAX package's three examples (``examples/*.py``) in the port, each a
``run`` that returns the numbers its example prints and a ``main`` that
prints them (``python -m repro_torch.examples.<name>``)."""
