"""flame_tpu_torch.ops (mirrors flame_tpu.ops)."""
