"""Architecture registry: ``--arch <id>`` resolution for the port.

Lists only the config modules ported so far; each has ``full()`` (the
published config) and ``smoke()`` (a reduced same-family config for CPU
tests). An id that the JAX package knows but the port does not yet has its
own error, so a caller learns it is waiting rather than misspelled.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.config.base import ArchConfig

# arch id → module under repro_torch.configs
_PORTED = {
    "igpm-pem": "igpm_paper",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

# the JAX package's other archs (repro.config.registry), not ported yet
_WAITING = ("bst", "dbrx-132b", "deepseek-7b", "dimenet", "graphcast",
            "meshgraphnet", "qwen2-72b", "schnet", "smollm-135m")


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in _PORTED:
        if arch_id in _WAITING:
            raise KeyError(f"arch {arch_id!r} is not ported to repro_torch "
                           f"yet (ported: {list_archs()}; see ROADMAP.md)")
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_PORTED[arch_id]}")
    return mod.smoke() if smoke else mod.full()


def list_archs() -> List[str]:
    return sorted(_PORTED)
