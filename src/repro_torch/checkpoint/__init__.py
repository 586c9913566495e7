"""Atomic, asynchronous training checkpoints."""
