from . import gnn  # noqa: F401
