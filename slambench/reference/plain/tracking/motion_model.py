"""Decaying constant-velocity motion model (port of
``rgbd_slam_tpu/tracking/motion_model.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..geometry import se3


class MotionModelState(NamedTuple):
    last_q: torch.Tensor           # [4] quaternion wxyz
    last_position: torch.Tensor    # [3]
    linear_velocity: torch.Tensor  # [3]
    angular_velocity: torch.Tensor # [4] quaternion wxyz
    is_set: torch.Tensor           # [] bool


def reset(dtype=torch.float32, device=None) -> MotionModelState:
    device = resolve_device(device)
    return MotionModelState(
        last_q=se3.quat_identity(dtype, device),
        last_position=torch.zeros(3, dtype=dtype, device=device),
        linear_velocity=torch.zeros(3, dtype=dtype, device=device),
        angular_velocity=se3.quat_identity(dtype, device),
        is_set=torch.zeros((), dtype=torch.bool, device=device),
    )


def predict_pose(state: MotionModelState, quat, position):
    """Apply the stored constant-velocity estimate to the given pose (identity
    until the model is set); no state update."""
    pred_position = torch.where(state.is_set, position + state.linear_velocity, position)
    pred_quat = torch.where(
        state.is_set, se3.quat_normalize(se3.quat_multiply(quat, state.angular_velocity)),
        quat)
    return pred_quat, pred_position


def predict_next_pose(state: MotionModelState, quat, position,
                      should_increase_variance: bool = False):
    """Predict the next pose and update the model.  Returns (new_state,
    predicted_quat, predicted_position, pose_var_inflation_66): the inflation is
    diag(10, 10, 10 mm, 0.1, 0.1, 0.1 rad)^2 when asked for, else zero."""
    dt = position.dtype
    new_lin_vel = ((position - state.last_position) + state.linear_velocity) * 0.5
    ang_diff = se3.quat_multiply(quat, se3.quat_conjugate(state.last_q))
    new_ang_vel = se3.quat_slerp(ang_diff, state.angular_velocity, 0.5)
    new_lin_vel = torch.where(state.is_set, new_lin_vel, torch.zeros_like(new_lin_vel))
    new_ang_vel = torch.where(state.is_set, new_ang_vel,
                              se3.quat_identity(dt, position.device))
    pred_position = torch.where(state.is_set, position + new_lin_vel, position)
    pred_quat = torch.where(
        state.is_set, se3.quat_normalize(se3.quat_multiply(quat, new_ang_vel)), quat)
    inflation = torch.zeros((6, 6), dtype=dt, device=position.device)
    if should_increase_variance:
        std = torch.tensor([10.0, 10.0, 10.0, 0.1, 0.1, 0.1], dtype=dt, device=position.device)
        inflation = torch.diag(std * std)
    new_state = MotionModelState(
        last_q=quat, last_position=position, linear_velocity=new_lin_vel,
        angular_velocity=new_ang_vel,
        is_set=torch.ones((), dtype=torch.bool, device=position.device))
    return new_state, pred_quat, pred_position, inflation
