"""The port's checkpoints: ``checkpoint.ckpt`` (counterpart of
``repro.checkpoint.ckpt``; the same files)."""
