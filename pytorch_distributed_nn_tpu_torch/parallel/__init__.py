"""Data parallelism of the port over ``torch.distributed``: process
groups (:mod:`.mesh`) and the gradient-sync stage (:mod:`.grad_sync`)."""
