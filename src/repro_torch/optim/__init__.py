"""Optimizer and LR schedules (PyTorch counterparts of ``repro.optim``)."""
