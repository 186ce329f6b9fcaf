"""Checkpoints and the metrics logger."""
