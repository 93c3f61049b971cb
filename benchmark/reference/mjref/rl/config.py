"""RL configuration dataclasses.

Counterpart of mjlab_tpu/rl/config.py, field for field, for the PyTorch PPO
learner of mjref/rl/ppo.py. `device` is the runner's device, 'cuda'
unless the caller asks for 'cpu'; it must be the env's. Checkpoints are
`model_{iteration}.pt` files (`load_checkpoint`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass
class RslRlPpoActorCriticCfg:
  class_name: str = 'ActorCritic'
  init_noise_std: float = 1.0
  noise_std_type: Literal['scalar', 'log'] = 'scalar'
  # obs normalization is off unless a task opts in: a running normalizer
  # hit by one exploded-physics batch stays poisoned, which is what a
  # locomotion task with early falls risks
  actor_obs_normalization: bool = False
  critic_obs_normalization: bool = False
  actor_hidden_dims: tuple = (512, 256, 128)
  critic_hidden_dims: tuple = (512, 256, 128)
  activation: str = 'elu'


@dataclasses.dataclass
class RslRlPpoAlgorithmCfg:
  class_name: str = 'PPO'
  num_learning_epochs: int = 5
  num_mini_batches: int = 4
  learning_rate: float = 1e-3
  schedule: Literal['adaptive', 'fixed'] = 'adaptive'
  gamma: float = 0.99
  lam: float = 0.95
  entropy_coef: float = 0.005
  desired_kl: float = 0.01
  max_grad_norm: float = 1.0
  value_loss_coef: float = 1.0
  use_clipped_value_loss: bool = True
  clip_param: float = 0.2
  normalize_advantage_per_mini_batch: bool = False


@dataclasses.dataclass
class RslRlOnPolicyRunnerCfg:
  seed: int = 42
  device: str = 'cuda'
  num_steps_per_env: int = 24
  max_iterations: int = 30000
  save_interval: int = 500
  experiment_name: str = 'exp'
  run_name: str = ''
  logger: Literal['jsonl', 'tensorboard', 'wandb', 'none'] = 'jsonl'
  # training videos: env 0's qpos over the rollouts, drawn offscreen
  # (viewer/offscreen.py) every video_interval iterations into
  # <log_dir>/videos/train/rl-video-iter-{it}.mp4
  video: bool = False
  video_length: int = 200  # frames
  video_interval: int = 2000  # iterations
  # group routing: actor reads obs_groups['policy'], critic obs_groups['critic']
  obs_groups: dict = dataclasses.field(default_factory=lambda: {
      'policy': ['policy'], 'critic': ['policy', 'critic']})
  clip_actions: float | None = None
  resume: bool = False
  load_run: str = '.*'
  load_checkpoint: str = r'model_.*\.pt'
  policy: RslRlPpoActorCriticCfg = dataclasses.field(
      default_factory=RslRlPpoActorCriticCfg)
  algorithm: RslRlPpoAlgorithmCfg = dataclasses.field(
      default_factory=RslRlPpoAlgorithmCfg)
