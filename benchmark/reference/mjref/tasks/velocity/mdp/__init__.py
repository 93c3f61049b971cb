"""Velocity-task MDP term namespace (base terms + task-specific)."""

from mjref.envs.mdp import *  # noqa: F401,F403
from mjref.tasks.velocity.mdp.curriculums import (  # noqa: F401
    commands_vel,
    terrain_levels_vel,
)
from mjref.tasks.velocity.mdp.rewards import (  # noqa: F401
    feet_air_time,
    feet_slide,
    foot_clearance_reward,
    track_ang_vel_exp,
    track_lin_vel_exp,
)
from mjref.tasks.velocity.mdp.velocity_command import (  # noqa: F401
    UniformVelocityCommand,
    UniformVelocityCommandCfg,
)
