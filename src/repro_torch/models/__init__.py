"""Model zoo of the port: ResNet-50 inference (``resnet.py``), the dense
transformer's serving path (``transformer.py``: prefill, KV cache, decode)
and Mamba2's (``mamba.py`` over ``ssd.py``: chunked prefill on the SSD scan
kernel, recurrent decode) behind ``api.build_model``; ``layers.py`` holds
the layers they share."""
