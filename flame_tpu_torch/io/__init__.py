"""flame_tpu_torch.io (mirrors flame_tpu.io)."""
