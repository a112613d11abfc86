"""Step builders of the port (see ``repro.train`` for the reference):
the train and serve steps of ``train.steps``."""
