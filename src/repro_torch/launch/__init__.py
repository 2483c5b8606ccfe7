"""Entry points of the port run as modules (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``)."""
