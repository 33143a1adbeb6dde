"""Measurement scripts of the port, run on the card
(``python -m pytorch_distributed_nn_tpu_torch.tools.<name>``)."""
