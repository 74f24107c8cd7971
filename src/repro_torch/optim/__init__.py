"""Optimizers of the port.

The counterpart of ``repro.optim``: :mod:`repro_torch.optim.adamw` ports
the reference's functional AdamW.  ``compress`` (gradient compression)
waits for model training.
"""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, cosine_lr, global_norm)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_lr", "global_norm"]
