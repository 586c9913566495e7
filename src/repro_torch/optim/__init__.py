"""Optimizer, learning-rate schedule and gradient compression of the training path."""
