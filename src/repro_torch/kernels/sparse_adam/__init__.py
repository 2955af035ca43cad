from .kernel import sparse_adam_cuda
from .ops import StagingArena, sparse_adam_apply, sparse_adam_staged
from .ref import sparse_adam_ref

__all__ = ["StagingArena", "sparse_adam_apply", "sparse_adam_cuda",
           "sparse_adam_ref", "sparse_adam_staged"]
