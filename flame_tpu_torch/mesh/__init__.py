"""flame_tpu_torch.mesh (mirrors flame_tpu.mesh)."""
