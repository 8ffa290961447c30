"""Training and evaluation: metrics, optimizer, checkpoints and the engine."""
