"""A configuration's model family, found by name: ``families/<family>.py``
for the family that the configuration file's ``port`` block names (the
port's own ``ModelConfig.family``). A family module gives the harness

* ``shape_of(cfg)``: the sizes its counts and its reference read;
* ``port_fields(cfg)``: the port's ``ModelConfig`` fields that follow from
  the published keys (the ``port`` block adds or replaces fields as is);
* ``leaves(cfg)``: the backbone's leaves for ``weights.draw_backbone``;
* ``train_row_flops``, ``prefill_flops``, ``decode_flops``, ``flash_call``,
  ``grouped_lora_call``: the required work, as ``counts.py`` defines it;
* ``reference``: its plain reference (``nanoedge``, ``layer_context``,
  ``layer``, ``head``; see ``reference/decoder.py``).

A new family is a new module here and its reference beside the others."""
import importlib


def load(cfg: dict):
    return importlib.import_module(f"fedbench.families.{cfg['port']['family']}")
