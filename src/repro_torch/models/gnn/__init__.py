from .layers import sage_layer
from .models import (GNNConfig, apply_gnn, apply_gnn_layer, init_gnn,
                     params_from_numpy, params_to)

__all__ = ["GNNConfig", "apply_gnn", "apply_gnn_layer", "init_gnn",
           "params_from_numpy", "params_to", "sage_layer"]
