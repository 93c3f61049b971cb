"""Base MDP term library (counterpart of mjlab_tpu/envs/mdp)."""

from mjref.envs.mdp.actions import (  # noqa: F401
    JointAction,
    JointPositionAction,
    JointPositionActionCfg,
)
from mjref.envs.mdp.events import (  # noqa: F401
    FIELD_SPECS,
    apply_external_force_torque,
    push_by_setting_velocity,
    randomize_field,
    reset_joints_by_scale,
    reset_root_state_uniform,
    reset_scene_to_default,
)
from mjref.envs.mdp.observations import (  # noqa: F401
    base_ang_vel,
    base_lin_vel,
    generated_commands,
    joint_pos,
    joint_pos_rel,
    joint_vel,
    joint_vel_rel,
    last_action,
    projected_gravity,
    root_pos_w,
    root_quat_w,
)
from mjref.envs.mdp.rewards import (  # noqa: F401
    action_l2,
    action_rate_l2,
    electrical_power_cost,
    flat_orientation_l2,
    is_alive,
    is_terminated,
    joint_acc_l2,
    joint_pos_limits,
    joint_torques_l2,
    joint_vel_l2,
    posture,
    upright,
)
from mjref.envs.mdp.terminations import (  # noqa: F401
    bad_orientation,
    root_height_below_minimum,
    time_out,
)
