"""Snapshot directories (`ckpt.py`)."""
