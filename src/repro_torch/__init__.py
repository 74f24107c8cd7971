"""PyTorch/CUDA port of the carbon-aware DAG job-shop scheduler.

A second package beside the JAX reference ``repro``, with the same module
paths (``repro/core/decoder.py`` -> ``repro_torch/core/decoder.py``).  It
imports torch and numpy, never jax and nothing of ``repro``.  Entry points
run on the card (``device="cuda"``) unless asked for the CPU.

    core     — instances, traces, objectives, validator, decoders, solvers
    kernels  — hand-written Hopper kernels beside their plain versions
    bench    — the paper benchmark (``python -m repro_torch.bench``)
"""
