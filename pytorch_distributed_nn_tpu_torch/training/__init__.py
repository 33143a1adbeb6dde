"""Training of the port: the data-parallel steps of the transformer
family (MLM) and of the CNN zoo (``config``, ``train_step``,
``trainer``), the dp x tp x sp step of the transformer family
(``spmd``), checkpoints in the JAX package's file and sharded-directory
formats (``checkpoint``), their background writer (``async_ckpt``), the
vocabulary-curriculum warm start (``warm_start``) and the polling
evaluator (``evaluator``)."""
