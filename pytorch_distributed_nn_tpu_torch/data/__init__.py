"""Data of the port: the synthetic masked-LM corpus (``text``)."""
