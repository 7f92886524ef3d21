"""flame_tpu_torch.stereo (mirrors flame_tpu.stereo)."""
