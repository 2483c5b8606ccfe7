"""Model zoo of the port: ResNet-50 inference (``resnet.py``) and the dense
transformer's serving path (``transformer.py``: prefill, KV cache, decode)
behind ``api.build_model``; ``layers.py`` holds the layers they share."""
