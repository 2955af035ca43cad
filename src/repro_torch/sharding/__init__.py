"""Sharding rules as DTensor placements; the port of ``repro.sharding``."""
from .rules import (AXIS_SIZES, AxisRules, active_mesh, batch_spec,
                    current_rules, distribute, maybe_constrain, param_pspecs,
                    placements, set_rules, spec)

__all__ = ["AXIS_SIZES", "AxisRules", "active_mesh", "batch_spec",
           "current_rules", "distribute", "maybe_constrain", "param_pspecs",
           "placements", "set_rules", "spec"]
