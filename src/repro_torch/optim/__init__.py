from .optimizers import (AdamWState, adamw_init, adamw_update, sgd_update,
                         clip_by_global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "sgd_update",
           "clip_by_global_norm"]
