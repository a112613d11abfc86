"""The LM side of the port: ``common`` (``ModelConfig`` and the
primitives), ``mlp``, ``attention``, ``ssm`` and ``transformer``."""
