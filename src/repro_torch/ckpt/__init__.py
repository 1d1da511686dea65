"""Atomic checkpoints of the training state."""
