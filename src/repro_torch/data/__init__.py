"""Synthetic data of the port (numpy only): the same seeds give the same
batches as the reference package's ``data/pipeline.py``."""
