"""Carry parameters and training state of the JAX package across to the
port.

``params_from_jax_numpy(tree, cfg, device)`` takes the JAX parameter pytree
already converted to numpy (``jax.tree_util.tree_map(np.asarray, params)``
on the JAX side; bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays) and
returns the port's parameters on ``device``: the stacked ``layers`` leaves
become one dict per layer, so both packages compute the same function.
``train_state_from_jax_numpy`` does the same for a whole JAX ``TrainState``
(step, params, AdamW master/m/v, threshold state).  This module reads numpy
arrays only and never imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array (bf16 through its 16-bit pattern) -> torch tensor of the
    same shape (0-d stays 0-d)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _convert(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return tensor_from_numpy(a, device)


def params_from_jax_numpy(tree, cfg: ModelConfig, device=None):
    """JAX-layout numpy params -> the port's params on ``device``."""
    dev = resolve_device(device)
    out = {k: _convert(v, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(tree["layers"], dev, index=i)
                     for i in range(cfg.n_layers)]
    return out


def train_state_from_jax_numpy(state, cfg: ModelConfig, device=None):
    """A JAX ``repro.train.TrainState`` with numpy leaves (``tree_map(
    np.asarray, state)``: the named tuples keep their fields) -> the port's
    ``train.TrainState`` on ``device``."""
    from repro_torch.core import threshold
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainState
    dev = resolve_device(device)
    opt, thr = state.opt, state.thr
    return TrainState(
        step=int(np.asarray(state.step)),
        params=params_from_jax_numpy(state.params, cfg, dev),
        opt=adamw.AdamWState(
            step=int(np.asarray(opt.step)),
            master=params_from_jax_numpy(opt.master, cfg, dev),
            m=params_from_jax_numpy(opt.m, cfg, dev),
            v=params_from_jax_numpy(opt.v, cfg, dev)),
        thr=threshold.ThresholdState(
            ratio_ema=tensor_from_numpy(thr.ratio_ema, dev),
            sigma_q=tensor_from_numpy(thr.sigma_q, dev),
            step=int(np.asarray(thr.step)),
            crossed=tensor_from_numpy(thr.crossed, dev)))
