"""Hand-written Hopper kernels (:mod:`.kernels`, sources in ``csrc/``),
their plain PyTorch versions (:mod:`.reference`) and the host codecs."""
