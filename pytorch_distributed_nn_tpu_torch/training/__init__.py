"""Training of the port: single-device MLM training of the transformer
family (``config``, ``train_step``, ``trainer``)."""
