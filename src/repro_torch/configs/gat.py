"""The paper's GAT benchmark config (§6: 3 layers, hidden 256, 2 heads)."""
from ..models.gnn.models import GNNConfig

CONFIG = GNNConfig(arch="gat", in_dim=100, hidden_dim=256, num_classes=16,
                   fanouts=[15, 10, 5], batch_size=1000, num_heads=2)
