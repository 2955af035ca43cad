"""The LM zoo's serving path (prefill and ring-cache decode for every
family of ``repro_torch.configs.ARCH_IDS``), ported from
``repro.models.lm``."""
from .config import LMConfig, torch_dtype
from ..gnn.models import params_from_numpy  # the port's one converter
from .model import forward, init_params
from .decode import decode_step, init_cache, prefill
from .steps import make_decode_step, make_prefill_step

__all__ = [
    "LMConfig", "torch_dtype", "forward", "init_params", "params_from_numpy",
    "decode_step", "init_cache", "prefill", "make_decode_step",
    "make_prefill_step",
]
