"""Tiny sizes at which a CPU test drives a whole run of a cell: a few envs,
the small terrain grid of the port's own tests, a small learner."""

import copy

ENV = {'scene.num_envs': 4}
ROUGH = {f'scene.terrain.terrain_generator.{k}': v for k, v in {
    'num_rows': 2, 'num_cols': 3, 'size': (2.0, 2.0),
    'border_width': 1.0}.items()}
AGENT = {'num_steps_per_env': 3, 'policy.actor_hidden_dims': (16, 16),
         'policy.critic_hidden_dims': (16,),
         'algorithm.num_mini_batches': 2, 'algorithm.num_learning_epochs': 2}


def shrink(cell):
  """(the cell with its traffic cut to a CPU test's size, the overrides)."""
  cell = copy.deepcopy(cell)
  t = cell.traffic
  overrides = {'env': dict(ENV)}
  if t['driver'] == 'play':
    overrides['env'].update(ROUGH if 'rough' in cell.config['name'] else {})
    t.update(warmup_steps=1, profile_steps=2)
    t['check'] = dict(t['check'], within_steps=3)
  else:
    overrides['agent'] = dict(AGENT)
    t['warmup_iterations'] = 0
  return cell, overrides
