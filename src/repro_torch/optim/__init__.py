from .optimizers import AdamWState, adamw_init, adamw_update

__all__ = ["AdamWState", "adamw_init", "adamw_update"]
