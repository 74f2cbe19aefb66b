"""Operation and byte counts: each hand-written kernel's launch (rooflines)
and the model's work per training step or served request (`mfu.*`)."""
