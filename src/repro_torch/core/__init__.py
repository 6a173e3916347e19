"""FedNano's federated core in the port (``repro.core``)."""
from repro_torch.core import split
from repro_torch.core.client import ClientState, HyperParams, eval_client, local_update
from repro_torch.core.failures import FailureModel
from repro_torch.core.federated import FederatedResult, run_centralized, run_federated
from repro_torch.core.server import ServerState, init_server

__all__ = ["ClientState", "FailureModel", "FederatedResult", "HyperParams", "ServerState",
           "eval_client", "init_server", "local_update", "run_centralized", "run_federated",
           "split"]
