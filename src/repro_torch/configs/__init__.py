"""Architecture registry: importing this package registers every assigned
architecture (plus the paper's own experiment configs).  A copy of the JAX
package's ``configs`` (data only)."""
from repro_torch.configs.base import ArchConfig, get_config, list_configs, register

# Assigned architectures (10) — each module registers itself on import.
from repro_torch.configs import (  # noqa: F401
    qwen3_1p7b,
    codeqwen1p5_7b,
    jamba_1p5_large,
    whisper_medium,
    minitron_8b,
    deepseek_v2,
    kimi_k2,
    qwen2_1p5b,
    internvl2_2b,
    rwkv6_3b,
    paper,
)

__all__ = ["ArchConfig", "get_config", "list_configs", "register"]
