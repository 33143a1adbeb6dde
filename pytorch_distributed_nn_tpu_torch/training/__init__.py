"""Training of the port: the data-parallel steps of the transformer
family (MLM) and of the CNN zoo (``config``, ``train_step``,
``trainer``), checkpoints in the JAX package's file format
(``checkpoint``), their background writer (``async_ckpt``) and the
polling evaluator (``evaluator``)."""
