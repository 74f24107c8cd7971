"""Architecture registry of the port: ``--arch <id>`` resolves here.

The counterpart of ``repro.configs``, holding the three architectures whose
families the port runs (dense, ssm, hybrid); each module is a copy of the
reference's, with the published dims.  The other seven come with their
families (moe, encdec, vlm).
"""
from __future__ import annotations

from repro_torch.configs import hymba_1_5b, mamba2_370m, qwen15_05b
from repro_torch.models.common import ArchConfig

_MODULES = (qwen15_05b, mamba2_370m, hymba_1_5b)

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ALL_ARCHS = tuple(ARCHS)


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
