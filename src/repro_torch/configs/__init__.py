"""Named GNN configs (the paper's own models). The LM configs of
``repro.configs`` are not ported yet (ROADMAP queue A)."""
from __future__ import annotations

import importlib

from ..models.gnn.models import GNNConfig

GNN_ARCHS = ["graphsage", "gat", "rgcn"]          # the paper's own models


def get_config(arch_id: str) -> GNNConfig:
    if arch_id not in GNN_ARCHS:
        raise ValueError(f"unknown GNN arch {arch_id!r}; have {GNN_ARCHS}")
    return importlib.import_module(f".{arch_id}", __package__).CONFIG
