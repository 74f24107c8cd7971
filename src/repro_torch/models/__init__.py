"""The model substrate's serve path: dense, ssm and hybrid families.

The counterpart of ``repro.models``: configs and parameter trees
(``common``, ``params``), layers, attention (through the
``flash_attention`` kernel), the Mamba2 mixer (through ``ssd_scan``),
block assembly (``families``), the public prefill/decode API (``api``)
and the weight converter from the reference's numpy trees (``convert``).
"""
