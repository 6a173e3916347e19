"""The plain f32 reference that decides ``correct``: plain PyTorch, no kernel, nothing of the program."""


def family(cfg: dict):
    """The plain reference of a configuration's family, ``reference/<family>.py``."""
    import importlib

    return importlib.import_module(f"fedbench.reference.{cfg['port']['family']}")
