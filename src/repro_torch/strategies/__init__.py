"""Federated strategies of the port (``repro.strategies``): a method is a
``Strategy`` (client objective, merge, evaluation choice), a chain of
``UpdateTransform``s on the upload wire, an optional ``ServerOpt`` and a
``ClientSampler``."""
from repro_torch.strategies.base import (Strategy, available_strategies, get_strategy,
                                         register)
from repro_torch.strategies.builtin import (FedAdam, FedAvg, FedAvgM, FedDPAF, FedNano,
                                            FedNanoEF, FedProx, LocFT)
from repro_torch.strategies.sampling import (ClientSampler, FixedSizeSampler, UniformSampler,
                                             round_seed)
from repro_torch.strategies.server_opt import FedAdamOpt, FedAvgMOpt, FedBuffOpt, ServerOpt
from repro_torch.strategies.transforms import (WIRE_FORMAT_VERSION, ClipNoiseDP, Int8EFQuant,
                                               TopKSparsify, TransformCtx, UpdateTransform,
                                               WireMessage, decode_wire, default_transforms)

__all__ = ["Strategy", "available_strategies", "get_strategy", "register", "FedAdam",
           "FedAvg", "FedAvgM", "FedDPAF", "FedNano", "FedNanoEF", "FedProx", "LocFT",
           "ClientSampler", "FixedSizeSampler", "UniformSampler", "round_seed", "FedAdamOpt",
           "FedAvgMOpt", "FedBuffOpt", "ServerOpt", "WIRE_FORMAT_VERSION", "ClipNoiseDP", "Int8EFQuant",
           "TopKSparsify", "TransformCtx", "UpdateTransform", "WireMessage", "decode_wire",
           "default_transforms"]
