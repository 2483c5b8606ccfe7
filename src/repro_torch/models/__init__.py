"""Model zoo of the port.  So far the CNN family: ResNet-50 inference
(``resnet.py``) behind ``api.build_model``; ``layers.py`` holds the helpers
the models share."""
