from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, adamw_update_many

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_many"]
