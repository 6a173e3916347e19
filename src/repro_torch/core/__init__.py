"""FedNano's federated core in the port (``repro.core``)."""
from repro_torch.core.client import ClientState, HyperParams, eval_client, local_update
from repro_torch.core.federated import FederatedResult, run_federated
from repro_torch.core.server import ServerState, init_server

__all__ = ["ClientState", "FederatedResult", "HyperParams", "ServerState", "eval_client",
           "init_server", "local_update", "run_federated"]
