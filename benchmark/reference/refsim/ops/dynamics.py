"""Single-track vehicle dynamics, input constraints and the low-level PID map.

PyTorch counterpart of ``red_gym_tpu/ops/dynamics.py`` (reference:
gym/f110_gym/envs/dynamic_models.py:29-221).  Branch-free elementwise math
that broadcasts over any leading (env, agent) axes; the reference's branches
are ``torch.where`` selects.

State layout: ``x = [x, y, steer_angle, vel, yaw_angle, yaw_rate, slip_angle]``.
"""

from __future__ import annotations

import torch

from refsim.config import VehicleParams

G = 9.81


def accl_constraints(vel, accl, v_switch, a_max, v_min, v_max):
    """Acceleration limits incl. the wheel-spin power cap above ``v_switch``
    (reference dynamic_models.py:29-60)."""
    above_switch = vel > v_switch
    vel_safe = torch.where(above_switch, vel, torch.ones_like(vel))
    pos_limit = torch.where(above_switch, a_max * v_switch / vel_safe, a_max)
    clamped = torch.minimum(torch.maximum(accl, -a_max), pos_limit)
    pinned = ((vel <= v_min) & (accl <= 0.0)) | ((vel >= v_max) & (accl >= 0.0))
    return torch.where(pinned, torch.zeros_like(clamped), clamped)


def steering_constraint(steering_angle, steering_velocity, s_min, s_max,
                        sv_min, sv_max):
    """Steering-rate limits (reference dynamic_models.py:62-87)."""
    clamped = torch.minimum(torch.maximum(steering_velocity, sv_min), sv_max)
    pinned = ((steering_angle <= s_min) & (steering_velocity <= 0.0)) | (
        (steering_angle >= s_max) & (steering_velocity >= 0.0))
    return torch.where(pinned, torch.zeros_like(clamped), clamped)


def constrain_inputs_t(steer, vel, sv0, ac0, p: VehicleParams):
    """Both input constraints on unpacked components -> (sv, ac)."""
    sv = steering_constraint(steer, sv0, p.s_min, p.s_max, p.sv_min, p.sv_max)
    ac = accl_constraints(vel, ac0, p.v_switch, p.a_max, p.v_min, p.v_max)
    return sv, ac


def constrain_inputs(x, u_init, p: VehicleParams):
    """Both input constraints on the stacked state (..., 7) and controls
    (..., 2) -> the constrained controls (..., 2)."""
    sv, ac = constrain_inputs_t(x[..., 2], x[..., 3], u_init[..., 0],
                                u_init[..., 1], p)
    return torch.stack([sv, ac], dim=-1)


def vehicle_dynamics_ks_t(xt, sv0, ac0, p: VehicleParams):
    """Kinematic single-track RHS on a 5-tuple of state components
    (reference dynamic_models.py:91-121)."""
    sv, ac = constrain_inputs_t(xt[2], xt[3], sv0, ac0, p)
    lwb = p.lf + p.lr
    return (xt[3] * torch.cos(xt[4]),
            xt[3] * torch.sin(xt[4]),
            sv,
            ac,
            xt[3] / lwb * torch.tan(xt[2]))


def vehicle_dynamics_ks(x, u_init, p: VehicleParams):
    """Kinematic single-track RHS on the stacked state (..., 5)."""
    xt = tuple(x[..., i] for i in range(5))
    return torch.stack(vehicle_dynamics_ks_t(xt, u_init[..., 0], u_init[..., 1], p),
                       dim=-1)


def vehicle_dynamics_st_t(xt, sv0, ac0, p: VehicleParams):
    """Dynamic single-track RHS on a 7-tuple of state components
    (reference dynamic_models.py:123-176).  Below |v| = 0.5 the kinematic
    branch is selected per car; v is replaced by 1 in the untaken dynamic
    branch so that it stays finite."""
    sv, ac = constrain_inputs_t(xt[2], xt[3], sv0, ac0, p)
    lwb = p.lf + p.lr
    use_ks = torch.abs(xt[3]) < 0.5

    f_ks5 = vehicle_dynamics_ks_t(xt[:5], sv, ac, p)
    cos_s = torch.cos(xt[2])
    # lwb*(cos^2), as the reference associates it (dynamic_models.py:159)
    f_ks_6 = ac / lwb * torch.tan(xt[2]) + xt[3] / (lwb * (cos_s * cos_s)) * sv

    v = torch.where(use_ks, torch.ones_like(xt[3]), xt[3])
    delta, psi, wz, beta = xt[2], xt[4], xt[5], xt[6]
    glr_f = G * p.lr - ac * p.h   # front axle load lever
    glf_r = G * p.lf + ac * p.h   # rear axle load lever
    denom = p.lr + p.lf

    f_st = (
        v * torch.cos(beta + psi),
        v * torch.sin(beta + psi),
        sv,
        ac,
        wz,
        -p.mu * p.m / (v * p.I * denom)
        * (p.lf**2 * p.C_Sf * glr_f + p.lr**2 * p.C_Sr * glf_r) * wz
        + p.mu * p.m / (p.I * denom)
        * (p.lr * p.C_Sr * glf_r - p.lf * p.C_Sf * glr_f) * beta
        + p.mu * p.m / (p.I * denom) * p.lf * p.C_Sf * glr_f * delta,
        (p.mu / (v**2 * denom) * (p.C_Sr * glf_r * p.lr - p.C_Sf * glr_f * p.lf) - 1.0) * wz
        - p.mu / (v * denom) * (p.C_Sr * glf_r + p.C_Sf * glr_f) * beta
        + p.mu / (v * denom) * (p.C_Sf * glr_f) * delta,
    )
    f_ks7 = f_ks5 + (f_ks_6, torch.zeros_like(f_ks_6))
    return tuple(torch.where(use_ks, a, b) for a, b in zip(f_ks7, f_st))


def vehicle_dynamics_st(x, u_init, p: VehicleParams):
    """Dynamic single-track RHS on the stacked state (..., 7); the env step
    uses the component form ``vehicle_dynamics_st_t``."""
    xt = tuple(x[..., i] for i in range(7))
    return torch.stack(vehicle_dynamics_st_t(xt, u_init[..., 0], u_init[..., 1], p),
                       dim=-1)


def pid(speed, steer, current_speed, current_steer, max_sv, max_a, max_v, min_v):
    """Desired (speed, steer) -> (accl, steering velocity)
    (reference dynamic_models.py:178-221)."""
    steer_diff = steer - current_steer
    sv = torch.where(torch.abs(steer_diff) > 1e-4,
                     torch.sign(steer_diff) * max_sv,
                     torch.zeros_like(steer_diff))
    vel_diff = speed - current_speed
    fwd_gain = torch.where(vel_diff > 0.0, 10.0 * max_a / max_v,
                           10.0 * max_a / (-min_v))
    rev_gain = torch.where(vel_diff > 0.0, 2.0 * max_a / max_v,
                           2.0 * max_a / (-min_v))
    kp = torch.where(current_speed > 0.0, fwd_gain, rev_gain)
    return kp * vel_diff, sv
