from .kernel import gather_rows_cuda
from .ops import gather_rows
from .ref import gather_rows_ref

__all__ = ["gather_rows", "gather_rows_cuda", "gather_rows_ref"]
