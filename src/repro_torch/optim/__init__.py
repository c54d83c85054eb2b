"""Optimizers and the learning-rate schedule (`optimizers.py`)."""
