"""The train step and loop (`trainer.py`)."""
