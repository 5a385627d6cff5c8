"""Architecture registry: ``--arch <id>`` resolution for the port.

Lists the config modules, the same eleven archs as the JAX package's
registry; each has ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests). ``register_arch`` adds a
factory pair, as the JAX package's registry does.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config.base import ArchConfig

# arch id → module under repro_torch.configs
_PORTED = {
    "igpm-pem": "igpm_paper",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "smollm-135m": "smollm_135m",
    "deepseek-7b": "deepseek_7b",
    "qwen2-72b": "qwen2_72b",
    "dbrx-132b": "dbrx_132b",
    "dimenet": "dimenet",
    "schnet": "schnet",
    "graphcast": "graphcast",
    "meshgraphnet": "meshgraphnet",
    "bst": "bst",
}

_REGISTERED: Dict[str, Callable[[], ArchConfig]] = {}
_REGISTERED_SMOKE: Dict[str, Callable[[], ArchConfig]] = {}


def register_arch(arch_id: str, full: Callable[[], ArchConfig],
                  smoke: Callable[[], ArchConfig]) -> None:
    _REGISTERED[arch_id] = full
    _REGISTERED_SMOKE[arch_id] = smoke


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id in _REGISTERED:
        return (_REGISTERED_SMOKE if smoke else _REGISTERED)[arch_id]()
    if arch_id not in _PORTED:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_PORTED[arch_id]}")
    return mod.smoke() if smoke else mod.full()


def list_archs() -> List[str]:
    return sorted(set(_PORTED) | set(_REGISTERED))
