"""Model configuration of the port (``common.ModelConfig``)."""
