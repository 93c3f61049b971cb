"""G1 motion-tracking task registrations (flat terrain)."""

from mjlab_torch.asset_zoo.pretrained import (
    G1_TRACKING_MOTION,
    G1_TRACKING_POLICY,
)
from mjlab_torch.tasks import registry
from mjlab_torch.tasks.tracking.config.g1.flat_env_cfg import (
    G1FlatEnvCfg,
    G1FlatEnvCfg_PLAY,
    G1FlatNoStateEstimationEnvCfg,
    G1FlatNoStateEstimationEnvCfg_PLAY,
)


def _rl_cfg():
  """The G1 tracking runner cfg of mjlab_tpu/tasks/tracking/config/g1/
  __init__.py: observation normalization on for actor and critic,
  (512, 256, 128) networks, entropy 0.005, 30k-iteration budget."""
  from mjlab_torch.rl.config import (
      RslRlOnPolicyRunnerCfg,
      RslRlPpoActorCriticCfg,
      RslRlPpoAlgorithmCfg,
  )
  return RslRlOnPolicyRunnerCfg(
      experiment_name='g1_tracking',
      policy=RslRlPpoActorCriticCfg(
          init_noise_std=1.0,
          actor_obs_normalization=True,
          critic_obs_normalization=True,
          actor_hidden_dims=(512, 256, 128),
          critic_hidden_dims=(512, 256, 128),
          activation='elu'),
      algorithm=RslRlPpoAlgorithmCfg(
          value_loss_coef=1.0, use_clipped_value_loss=True, clip_param=0.2,
          entropy_coef=0.005, num_learning_epochs=5, num_mini_batches=4,
          learning_rate=1.0e-3, schedule='adaptive', gamma=0.99, lam=0.95,
          desired_kl=0.01, max_grad_norm=1.0),
      save_interval=500, num_steps_per_env=24, max_iterations=30_000)


# the shipped policy was trained on the walk clip shipped beside it, and
# plays on it (scripts/play.py)
_SHIPPED = dict(pretrained_policy=G1_TRACKING_POLICY,
                pretrained_motion=G1_TRACKING_MOTION)

registry.register('Mjlab-Tracking-Flat-Unitree-G1',
                  env_cfg_entry_point=G1FlatEnvCfg,
                  rl_cfg_entry_point=_rl_cfg, **_SHIPPED)
registry.register('Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation',
                  env_cfg_entry_point=G1FlatNoStateEstimationEnvCfg,
                  rl_cfg_entry_point=_rl_cfg)
registry.register('Mjlab-Tracking-Flat-Unitree-G1-Play',
                  env_cfg_entry_point=G1FlatEnvCfg_PLAY,
                  rl_cfg_entry_point=_rl_cfg, **_SHIPPED)
registry.register('Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation-Play',
                  env_cfg_entry_point=G1FlatNoStateEstimationEnvCfg_PLAY,
                  rl_cfg_entry_point=_rl_cfg)
