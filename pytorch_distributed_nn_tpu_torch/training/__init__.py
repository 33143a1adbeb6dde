"""Training of the port: the transformer family's MLM step on one device
and the CNN zoo's data-parallel step (``config``, ``train_step``,
``trainer``), checkpoints in the JAX package's file format
(``checkpoint``), their background writer (``async_ckpt``) and the
polling evaluator (``evaluator``)."""
