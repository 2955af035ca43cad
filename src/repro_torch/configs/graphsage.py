"""The paper's GraphSAGE benchmark config (§6: 3 layers, hidden 256,
fanout 15/10/5, 2 heads n/a)."""
from ..models.gnn.models import GNNConfig

CONFIG = GNNConfig(arch="graphsage", in_dim=100, hidden_dim=256,
                   num_classes=16, fanouts=[15, 10, 5], batch_size=1000)
