"""Federated strategies of the port (``repro.strategies``): FedNano only."""
from repro_torch.strategies.base import Strategy, get_strategy, register
from repro_torch.strategies.builtin import FedNano

__all__ = ["FedNano", "Strategy", "get_strategy", "register"]
