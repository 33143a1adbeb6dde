"""Parallelism of the port over ``torch.distributed``: process groups and
the (data, seq, model) mesh (:mod:`.mesh`), the gradient-sync stage
(:mod:`.grad_sync`), the partition rules and shard arithmetic of tensor
parallelism (:mod:`.partitioning`), its collectives as autograd functions
(:mod:`.tensor_parallel`), and ring and Ulysses attention
(:mod:`.ring_attention`)."""
