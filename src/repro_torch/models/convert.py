"""The reference's weights carried across to the port.

:func:`params_from_numpy` takes the reference's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and returns
a :class:`~repro_torch.models.api.Model` holding the same numbers, so that
both packages compute the same function.  It imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.api import Model, model_defs
from repro_torch.models.common import ArchConfig
from repro_torch.models.params import ParamDef
from repro_torch.models.parallel import ParallelCfg


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device = DEFAULT_DEVICE,
                      par: ParallelCfg = ParallelCfg()) -> Model:
    """A Model of ``cfg`` whose parameters are the arrays of ``tree``.

    ``tree`` must have exactly the paths and shapes of ``model_defs(cfg)``;
    each array is converted to its ParamDef's dtype.
    """
    dev = resolve_device(device)

    def walk(defs, t, path):
        if isinstance(defs, ParamDef):
            a = np.asarray(t)
            if a.shape != defs.shape:
                raise ValueError(f"{path}: shape {a.shape}, expected "
                                 f"{defs.shape}")
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=defs.dtype)
        if not isinstance(t, dict) or set(t) != set(defs):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            raise ValueError(f"{path or 'tree'}: keys {got}, expected "
                             f"{sorted(defs)}")
        return {k: walk(defs[k], t[k], f"{path}.{k}".lstrip("."))
                for k in sorted(defs)}

    return Model(cfg, walk(model_defs(cfg), tree, ""), par)
