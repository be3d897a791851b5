"""Checkpoints in the reference's MessagePack format (``store``)."""
