from .layers import gat_layer, rgcn_layer, sage_layer
from .models import (GNNConfig, apply_gnn, apply_gnn_layer, init_gnn,
                     nc_accuracy, nc_loss, params_from_numpy, params_to)

__all__ = ["GNNConfig", "apply_gnn", "apply_gnn_layer", "gat_layer",
           "init_gnn", "nc_accuracy", "nc_loss", "params_from_numpy",
           "params_to", "rgcn_layer", "sage_layer"]
