"""flame_tpu_torch.utils (mirrors flame_tpu.utils)."""
