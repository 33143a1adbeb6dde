"""PyTorch/CUDA port of ``pytorch_distributed_nn_tpu``.

It keeps the JAX package's layout and module names, imports nothing of
it, and runs on an NVIDIA Hopper card: the TPU's Pallas kernels become
hand-written CUDA kernels (``ops/csrc/``). It serves the causal
decoders and single-pass artifacts (``serving/``, with the registry,
canaries and the replicated frontend), trains the transformer family
and the CNN zoo (``training/``, with checkpoints in the JAX package's
format, resume and the polling evaluator), and its entry points run on
the card unless the caller passes ``device="cpu"``.
"""
