"""The trainer, the plateau learning-rate machine and checkpoints."""
