"""The plain float32 reference of the benchmark's training cells: the
shared pieces (sample format, TF32 control, aggregations, loss, AdamW) in
plain PyTorch (``model``; each architecture's ``forward`` is its plug-in's,
``gnnbench/archs/``), and the check of a run's first steps against it
(``check``). Imports nothing of the program under test."""
