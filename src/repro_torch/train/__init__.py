"""Step builders of the port (see ``repro.train`` for the reference):
the serving steps of ``train.steps``."""
