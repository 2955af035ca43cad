"""The paper's RGCN benchmark config (§6: 2 layers, hidden 1024,
fanout 25/15)."""
from ..models.gnn.models import GNNConfig

CONFIG = GNNConfig(arch="rgcn", in_dim=128, hidden_dim=1024, num_classes=16,
                   fanouts=[25, 15], batch_size=1000, num_rels=4)
