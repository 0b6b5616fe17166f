"""Training: the packed synthetic data stream (``data``) and the Adam /
Adafactor optimizers with the functional train step (``optimizer``)."""
