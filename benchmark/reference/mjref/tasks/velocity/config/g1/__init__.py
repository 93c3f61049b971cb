"""G1 velocity task registrations (flat and rough terrain)."""

from mjref.tasks import registry
from mjref.tasks.velocity.config.g1.flat_env_cfg import UnitreeG1FlatEnvCfg


def _g1_ppo_cfg(experiment_name):
  """The G1 runner cfg of mjlab_tpu/tasks/velocity/config/g1/__init__.py
  (reference tasks/velocity/config/g1/rl_cfg.py): obs normalization off,
  (512, 256, 128) networks, entropy 0.01, 30k-iteration budget."""
  from mjref.rl.config import (
      RslRlOnPolicyRunnerCfg,
      RslRlPpoActorCriticCfg,
      RslRlPpoAlgorithmCfg,
  )
  return RslRlOnPolicyRunnerCfg(
      experiment_name=experiment_name,
      policy=RslRlPpoActorCriticCfg(
          init_noise_std=1.0,
          actor_obs_normalization=False,
          critic_obs_normalization=False,
          actor_hidden_dims=(512, 256, 128),
          critic_hidden_dims=(512, 256, 128),
          activation='elu'),
      algorithm=RslRlPpoAlgorithmCfg(
          value_loss_coef=1.0, use_clipped_value_loss=True, clip_param=0.2,
          entropy_coef=0.01, num_learning_epochs=5, num_mini_batches=4,
          learning_rate=1.0e-3, schedule='adaptive', gamma=0.99, lam=0.95,
          desired_kl=0.01, max_grad_norm=1.0),
      save_interval=50, num_steps_per_env=24, max_iterations=30_000)


def _rl_cfg():
  return _g1_ppo_cfg('g1_flat')


def _rl_cfg_rough():
  return _g1_ppo_cfg('g1_rough')


def _rough_cfg():
  from mjref.tasks.velocity.config.g1.rough_env_cfg import (
      UnitreeG1RoughEnvCfg,
  )
  return UnitreeG1RoughEnvCfg()


registry.register('Mjlab-Velocity-Flat-Unitree-G1',
                  env_cfg_entry_point=UnitreeG1FlatEnvCfg,
                  rl_cfg_entry_point=_rl_cfg)
registry.register('Mjlab-Velocity-Rough-Unitree-G1',
                  env_cfg_entry_point=_rough_cfg,
                  rl_cfg_entry_point=_rl_cfg_rough)
