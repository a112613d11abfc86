"""The port's data pipeline: ``data.synthetic``, a numpy copy of
``repro.data.synthetic``."""
