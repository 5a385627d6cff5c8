from repro_torch.config.base import (EngineConfig, IGPMConfig, ServingConfig,
                                     resolve_backend)

__all__ = ["IGPMConfig", "EngineConfig", "ServingConfig", "resolve_backend"]
