from .kernel import src_scatter_cuda
from .ref import src_scatter_ref

__all__ = ["src_scatter_cuda", "src_scatter_ref"]
