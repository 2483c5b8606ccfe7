"""Checkpoints of the port (``repro_torch.checkpoint.store``)."""
