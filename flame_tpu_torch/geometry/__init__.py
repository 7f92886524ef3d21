from flame_tpu_torch.geometry import camera, epipolar, se3

__all__ = ["se3", "camera", "epipolar"]
