"""flame_tpu_torch.optimize (mirrors flame_tpu.optimize)."""
