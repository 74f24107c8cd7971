"""Architecture registry of the port: ``--arch <id>`` resolves here.

The counterpart of ``repro.configs``: all ten architectures, each module a
copy of the reference's with the published dims, listed in the
reference's order.  The cluster's energy model prices every one of them;
``models.build_model`` builds the dense, ssm and hybrid families without
a frontend and refuses the rest (moe, encdec, the vision frontend).
"""
from __future__ import annotations

from repro_torch.configs import (codeqwen15_7b, deepseek_67b, hymba_1_5b,
                                 kimi_k2_1t_a32b, llava_next_34b,
                                 mamba2_370m, minitron_4b, qwen15_05b,
                                 qwen3_moe_30b_a3b, whisper_base)
from repro_torch.models.common import ArchConfig

_MODULES = (llava_next_34b, codeqwen15_7b, deepseek_67b, minitron_4b,
            qwen15_05b, whisper_base, mamba2_370m, qwen3_moe_30b_a3b,
            kimi_k2_1t_a32b, hymba_1_5b)

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ALL_ARCHS = tuple(ARCHS)


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
