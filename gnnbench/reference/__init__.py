"""The plain float32 reference of the benchmark's training cells: GraphSAGE
and GAT over the sampled blocks, their cross-entropy loss, gradients and
AdamW, in plain PyTorch (``model``), and the check of a run's first steps
against it (``check``). Imports nothing of the program under test."""
