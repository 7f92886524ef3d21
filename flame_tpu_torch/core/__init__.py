"""flame_tpu_torch.core (mirrors flame_tpu.core)."""
