"""The LM zoo (every family of ``repro_torch.configs.ARCH_IDS``), ported
from ``repro.models.lm``: the forward, prefill and ring-cache decode for
serving, and the training loss and step."""
from .config import LMConfig, torch_dtype
from ..gnn.models import params_from_numpy  # the port's one converter
from .model import abstract_params, forward, init_params
from .decode import decode_step, init_cache, prefill
from .steps import (init_train_state, lm_loss, make_decode_step,
                    make_prefill_step, make_train_step)

__all__ = [
    "LMConfig", "torch_dtype", "abstract_params", "forward", "init_params", "params_from_numpy",
    "decode_step", "init_cache", "prefill", "lm_loss", "make_train_step",
    "init_train_state", "make_decode_step", "make_prefill_step",
]
