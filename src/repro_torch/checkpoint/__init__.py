"""Checkpoints of the port (``repro.checkpoint``): trees <-> npz, server
checkpoints, and the full round state a run resumes from."""
from repro_torch.checkpoint.io import (SEED_KEY_TAG, SERVER_CHECKPOINT_VERSION,
                                       CheckpointError, CheckpointVersionError, flatten_pytree,
                                       load_adapters, load_pytree, load_server_checkpoint,
                                       save_pytree, save_server_checkpoint, seed_key,
                                       unflatten_pytree)
from repro_torch.checkpoint.run_state import (RUN_STATE_VERSION, BufferedState, RunState,
                                              load_run_state, read_run_meta,
                                              resolve_run_state_dir, save_run_state)

__all__ = ["SEED_KEY_TAG", "SERVER_CHECKPOINT_VERSION", "CheckpointError",
           "CheckpointVersionError", "flatten_pytree", "load_adapters", "load_pytree",
           "load_server_checkpoint", "save_pytree", "save_server_checkpoint", "seed_key",
           "unflatten_pytree", "RUN_STATE_VERSION", "BufferedState", "RunState",
           "load_run_state", "read_run_meta", "resolve_run_state_dir", "save_run_state"]
