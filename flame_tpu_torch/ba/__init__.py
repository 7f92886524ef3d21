"""flame_tpu_torch.ba (mirrors flame_tpu.ba): windowed bundle adjustment."""
