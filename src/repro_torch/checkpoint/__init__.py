"""Checkpoints in the reference's on-disk format (PyTorch counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint import ckpt

__all__ = ["ckpt"]
