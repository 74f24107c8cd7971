"""Hand-written Hopper kernels of the port, each beside its plain version.

  schedule_eval — per-task carbon-trace deltas of candidate schedules
                  (CUDA, ``csrc/schedule_eval.cu``; feeds
                  ``ops.population_carbon``, the SA/GA fitness hot loop)
  gate_quantile — order statistics of the online carbon gate's forecast
                  windows (CUDA, ``csrc/gate_quantile.cu``; feeds
                  ``ops.gate_threshold``, the dispatcher's gate)
  flash_attention — causal / sliding-window GQA attention (CUDA,
                  ``csrc/flash_attention.cu``; ``ops.flash_attention``,
                  every attention layer's prefill)
  ssd_scan      — the Mamba2 SSD chunk scan (CUDA, ``csrc/ssd_scan.cu``;
                  ``ops.ssd_scan``, every SSM layer's prefill)
  timing_sweep  — the carbon timing sweep of candidate schedules (CUDA,
                  ``csrc/timing_sweep.cu``; ``core.decoder.timing_sweep``
                  on CUDA tensors; it replaces no TPU kernel)

Each kernel: its CUDA source under ``csrc/``, a wrapper module that
checks its inputs, launches it and counts launches (``build.LAUNCHES``),
a plain version in ``ref.py`` (the timing sweep's is
``core.decoder.timing_sweep_plain``), and a public op in ``ops.py`` (the
timing sweep's is ``core.decoder.timing_sweep``).
"""
from repro_torch.kernels.build import LAUNCHES, reset_launches
from repro_torch.kernels.ops import (flash_attention, gate_threshold,
                                    population_carbon, ssd_scan)

__all__ = ["LAUNCHES", "flash_attention", "gate_threshold",
           "population_carbon", "reset_launches", "ssd_scan"]
