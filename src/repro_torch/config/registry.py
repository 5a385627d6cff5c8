"""Architecture registry: ``--arch <id>`` resolution for the port.

Lists the config modules ported so far; each has ``full()`` (the published
config) and ``smoke()`` (a reduced same-family config for CPU tests).
``register_arch`` adds a factory pair, as the JAX package's registry does.
An id that the JAX package knows but the port does not yet has its own
error, naming the ROADMAP item it waits for, so a caller learns it is
waiting rather than misspelled.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config.base import ArchConfig

# arch id → module under repro_torch.configs
_PORTED = {
    "igpm-pem": "igpm_paper",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

# the JAX package's other archs (repro.config.registry), not ported yet,
# with the ROADMAP item (queue 1) each waits for
_WAITING = {
    "dbrx-132b": "13.2", "deepseek-7b": "13.2", "qwen2-72b": "13.2",
    "smollm-135m": "13.2",
    "dimenet": "13.3", "graphcast": "13.3", "meshgraphnet": "13.3",
    "schnet": "13.3",
    "bst": "13.4",
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
        if arch_id in _WAITING:
            raise KeyError(f"arch {arch_id!r} is not ported to repro_torch "
                           f"yet (ported: {list_archs()}; see ROADMAP.md "
                           f"item {_WAITING[arch_id]})")
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_PORTED[arch_id]}")
    return mod.smoke() if smoke else mod.full()


def list_archs() -> List[str]:
    return sorted(set(_PORTED) | set(_REGISTERED))
