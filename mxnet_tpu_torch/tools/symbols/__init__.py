"""Symbolic networks of the training tools (the port of
``examples/image_classification/symbols/``)."""
