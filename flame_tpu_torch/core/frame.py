"""Frames and the fixed-capacity poseframe stack.

Port of flame_tpu/core/frame.py. A Frame holds the float image, its
reflect-101 padding and central gradients; poseframes live in a stacked
[F, ...] table with a validity mask so each feature gathers its anchor
frame's image and pose with one index. The JAX stack's packed-corner
sample table (img_pack) is not carried: the port samples img_pad directly.

The stack is updated in place. The JAX package's masked forms
(insert_masked, set_idepthmap_masked) exist only because a lax.scan body
cannot branch; the port's batch body is a Python loop, so it calls
insert and set_idepthmap when the frame is a poseframe and skips them
otherwise.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from flame_tpu_torch.ops.gradients import central_gradient


@dataclass
class Frame:
    frame_id: int
    q: torch.Tensor  # (4,) camera-to-world rotation
    t: torch.Tensor  # (3,) camera-to-world translation
    img: torch.Tensor  # (H, W) float32
    img_pad: torch.Tensor  # (H + 2p, W + 2p) reflect-101 padded
    gradx: torch.Tensor  # (H, W)
    grady: torch.Tensor  # (H, W)


def create(frame_id: int, q: torch.Tensor, t: torch.Tensor,
           img: torch.Tensor, pad: int) -> Frame:
    """Float image, reflect-101 padding, central gradients
    (reference frame.cc:33-71)."""
    f = img.float()
    img_pad = F.pad(f[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    gx, gy = central_gradient(f)
    return Frame(frame_id=int(frame_id), q=q.float(), t=t.float(), img=f,
                 img_pad=img_pad, gradx=gx, grady=gy)


@dataclass
class FrameStack:
    frame_id: torch.Tensor  # (F,) int32, -1 when free
    q: torch.Tensor  # (F, 4)
    t: torch.Tensor  # (F, 3)
    img_pad: torch.Tensor  # (F, H+2p, W+2p)
    gradx: torch.Tensor  # (F, H, W)
    grady: torch.Tensor  # (F, H, W)
    idepthmap: torch.Tensor  # (F, H, W) cached dense idepth (NaN = none)
    valid: torch.Tensor  # (F,) bool


def empty_stack(capacity: int, height: int, width: int, pad: int,
                device) -> FrameStack:
    Fc = capacity
    f32 = dict(dtype=torch.float32, device=device)
    q = torch.zeros((Fc, 4), **f32)
    q[:, 0] = 1.0
    return FrameStack(
        frame_id=torch.full((Fc,), -1, dtype=torch.int32, device=device),
        q=q, t=torch.zeros((Fc, 3), **f32),
        img_pad=torch.zeros((Fc, height + 2 * pad, width + 2 * pad), **f32),
        gradx=torch.zeros((Fc, height, width), **f32),
        grady=torch.zeros((Fc, height, width), **f32),
        idepthmap=torch.full((Fc, height, width), float("nan"), **f32),
        valid=torch.zeros((Fc,), dtype=torch.bool, device=device))


def _check_slot(stack: FrameStack, slot: int) -> int:
    slot = int(slot)
    if not 0 <= slot < stack.valid.shape[0]:
        raise IndexError(f"poseframe slot {slot} outside "
                         f"[0, {stack.valid.shape[0]})")
    return slot


def insert(stack: FrameStack, slot: int, frame: Frame) -> FrameStack:
    """Write a frame into a poseframe slot, in place. Unlike the JAX
    package, which clamps, an out-of-range slot raises."""
    slot = _check_slot(stack, slot)
    stack.frame_id[slot] = frame.frame_id
    stack.q[slot] = frame.q
    stack.t[slot] = frame.t
    stack.img_pad[slot] = frame.img_pad
    stack.gradx[slot] = frame.gradx
    stack.grady[slot] = frame.grady
    stack.idepthmap[slot] = float("nan")
    stack.valid[slot] = True
    return stack


def set_idepthmap(stack: FrameStack, slot: int,
                  idepthmap: torch.Tensor) -> FrameStack:
    stack.idepthmap[_check_slot(stack, slot)] = idepthmap
    return stack


def set_pose(stack: FrameStack, slot: int, q: torch.Tensor,
             t: torch.Tensor) -> FrameStack:
    """Update one poseframe pose in place (the updatePoseFramePoses hook,
    reference flame.h:155-164)."""
    slot = _check_slot(stack, slot)
    stack.q[slot] = q
    stack.t[slot] = t
    return stack


def set_poses(stack: FrameStack, slots, qs: torch.Tensor,
              qt: torch.Tensor) -> FrameStack:
    """Write several poses at once: slots (S,), qs (S, 4), qt (S, 3)."""
    idx = torch.as_tensor([_check_slot(stack, s) for s in slots],
                          dtype=torch.int64, device=stack.q.device)
    stack.q[idx] = qs.to(stack.q.dtype)
    stack.t[idx] = qt.to(stack.t.dtype)
    return stack


def remove(stack: FrameStack, slot: int) -> FrameStack:
    """Free a poseframe slot in place (its rows stay until overwritten)."""
    slot = _check_slot(stack, slot)
    stack.valid[slot] = False
    stack.frame_id[slot] = -1
    return stack

