"""Go1 velocity task registrations (flat and rough terrain). No trained
Go1 policy ships with the port."""

from mjlab_torch.tasks import registry
from mjlab_torch.tasks.velocity.config.go1.flat_env_cfg import (
    UnitreeGo1FlatEnvCfg,
    UnitreeGo1FlatEnvCfg_PLAY,
)


def _go1_ppo_cfg(experiment_name):
  """The Go1 runner cfg of mjlab_tpu/tasks/velocity/config/go1/__init__.py
  (reference tasks/velocity/config/go1/rl_cfg.py): obs normalization off,
  (512, 256, 128) networks, entropy 0.01, 10k-iteration budget."""
  from mjlab_torch.rl.config import (
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
      save_interval=50, num_steps_per_env=24, max_iterations=10_000)


def _rl_cfg():
  return _go1_ppo_cfg('go1_flat')


def _rl_cfg_rough():
  return _go1_ppo_cfg('go1_rough')


def _rough_cfg():
  from mjlab_torch.tasks.velocity.config.go1.rough_env_cfg import (
      UnitreeGo1RoughEnvCfg,
  )
  return UnitreeGo1RoughEnvCfg()


def _rough_cfg_play():
  from mjlab_torch.tasks.velocity.config.go1.rough_env_cfg import (
      UnitreeGo1RoughEnvCfg_PLAY,
  )
  return UnitreeGo1RoughEnvCfg_PLAY()


registry.register('Mjlab-Velocity-Flat-Unitree-Go1',
                  env_cfg_entry_point=UnitreeGo1FlatEnvCfg,
                  rl_cfg_entry_point=_rl_cfg)
registry.register('Mjlab-Velocity-Flat-Unitree-Go1-Play',
                  env_cfg_entry_point=UnitreeGo1FlatEnvCfg_PLAY,
                  rl_cfg_entry_point=_rl_cfg)
registry.register('Mjlab-Velocity-Rough-Unitree-Go1',
                  env_cfg_entry_point=_rough_cfg,
                  rl_cfg_entry_point=_rl_cfg_rough)
registry.register('Mjlab-Velocity-Rough-Unitree-Go1-Play',
                  env_cfg_entry_point=_rough_cfg_play,
                  rl_cfg_entry_point=_rl_cfg_rough)
