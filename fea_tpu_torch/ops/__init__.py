from .flash_attention import flash_attention
from .fused_norm import group_norm_silu

__all__ = ["flash_attention", "group_norm_silu"]
