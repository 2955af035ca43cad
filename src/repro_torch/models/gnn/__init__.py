from .layers import gat_layer, rgcn_layer, sage_layer
from .models import (LP_SCORE_FNS, GNNConfig, apply_gnn, apply_gnn_layer,
                     apply_head, init_gnn, init_lp_head, lp_loss,
                     lp_loss_from_scores, lp_metrics, lp_pair_scores,
                     lp_ranks, nc_accuracy, nc_loss, params_from_numpy,
                     params_to)

__all__ = ["GNNConfig", "LP_SCORE_FNS", "apply_gnn", "apply_gnn_layer",
           "apply_head", "gat_layer", "init_gnn", "init_lp_head", "lp_loss",
           "lp_loss_from_scores", "lp_metrics", "lp_pair_scores", "lp_ranks",
           "nc_accuracy", "nc_loss", "params_from_numpy", "params_to",
           "rgcn_layer", "sage_layer"]
