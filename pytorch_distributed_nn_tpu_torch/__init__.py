"""PyTorch/CUDA port of ``pytorch_distributed_nn_tpu``.

It keeps the JAX package's layout and module names, imports nothing of
it, and runs on an NVIDIA Hopper card: the TPU's Pallas kernels become
hand-written CUDA kernels (``ops/csrc/``). This slice is generative
serving of the causal decoders (``serving/generate/``, ``POST
/v1/generate``); entry points run on the card unless the caller passes
``device="cpu"``.
"""
