"""FedNano's federated core in the port (``repro.core``)."""
from repro_torch.core import (adapters, aggregation, client, comm, federated, fisher, server, split,
                              types)
from repro_torch.core.adapters import (fednano_loss, init_nano_adapter, init_nanoedge,
                                       nano_adapter_apply, nanoedge_forward)
from repro_torch.core.aggregation import STRATEGIES, aggregate, fedavg, fisher_merge
from repro_torch.core.client import (ClientState, HyperParams, eval_client, init_client,
                                     local_update)
from repro_torch.core.failures import FailureModel
from repro_torch.core.federated import FederatedResult, run_centralized, run_federated
from repro_torch.core.fisher import FisherAccumulator, fisher_pass
from repro_torch.core.server import ServerState, init_server, server_aggregate
from repro_torch.core.types import Batch

__all__ = [
    "adapters",
    "aggregation",
    "client",
    "comm",
    "federated",
    "fisher",
    "server",
    "split",
    "types",
    "fednano_loss",
    "init_nano_adapter",
    "init_nanoedge",
    "nano_adapter_apply",
    "nanoedge_forward",
    "STRATEGIES",
    "aggregate",
    "fedavg",
    "fisher_merge",
    "ClientState",
    "HyperParams",
    "eval_client",
    "init_client",
    "local_update",
    "FailureModel",
    "FederatedResult",
    "run_centralized",
    "run_federated",
    "FisherAccumulator",
    "fisher_pass",
    "ServerState",
    "init_server",
    "server_aggregate",
    "Batch",
]
