"""Architecture and shape configs: plain dataclasses, equal field by field to
the reference package's (``base.py``: ``ArchConfig``, ``ShapeConfig``,
``get_config``, ``ARCH_NAMES``; one module per architecture)."""
