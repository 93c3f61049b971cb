"""Go1 velocity task registrations (flat terrain; the rough variant waits
for ROADMAP 12.3). No trained Go1 policy ships with the port."""

from mjlab_torch.tasks import registry
from mjlab_torch.tasks.velocity.config.go1.flat_env_cfg import (
    UnitreeGo1FlatEnvCfg,
    UnitreeGo1FlatEnvCfg_PLAY,
)


def _rl_cfg():
  """The Go1 runner cfg of mjlab_tpu/tasks/velocity/config/go1/__init__.py
  (reference tasks/velocity/config/go1/rl_cfg.py): obs normalization off,
  (512, 256, 128) networks, entropy 0.01, 10k-iteration budget."""
  from mjlab_torch.rl.config import (
      RslRlOnPolicyRunnerCfg,
      RslRlPpoActorCriticCfg,
      RslRlPpoAlgorithmCfg,
  )
  return RslRlOnPolicyRunnerCfg(
      experiment_name='go1_flat',
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


registry.register('Mjlab-Velocity-Flat-Unitree-Go1',
                  env_cfg_entry_point=UnitreeGo1FlatEnvCfg,
                  rl_cfg_entry_point=_rl_cfg)
registry.register('Mjlab-Velocity-Flat-Unitree-Go1-Play',
                  env_cfg_entry_point=UnitreeGo1FlatEnvCfg_PLAY,
                  rl_cfg_entry_point=_rl_cfg)
