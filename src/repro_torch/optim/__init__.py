"""Optimizers of the port.

The counterpart of ``repro.optim``: :mod:`repro_torch.optim.adamw` ports
the reference's functional AdamW, :mod:`repro_torch.optim.compress` its
int8 error-feedback gradient compression.
"""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, cosine_lr, global_norm)
from repro_torch.optim.compress import (CompressState, compress_init,
                                        compressed_grads)

__all__ = ["AdamWConfig", "CompressState", "OptState", "adamw_init",
           "adamw_update", "compress_init", "compressed_grads", "cosine_lr",
           "global_norm"]
