"""The port's optimizer: ``optim.adamw`` (counterpart of
``repro.optim.adamw``)."""
