"""Print the port's task registry.

Counterpart of mjlab_tpu/scripts/list_envs.py:

    python -m mjlab_torch.scripts.list_envs
"""

from __future__ import annotations


def main(argv=None):
  from mjlab_torch.tasks import registry
  tasks = registry.registered_tasks()
  width = max(len(t) for t in tasks) if tasks else 10
  print(f'{"Task ID":<{width}}  entry points')
  print('-' * (width + 30))
  for t in tasks:
    print(f'{t:<{width}}  env_cfg + rl_cfg')
  return tasks


if __name__ == '__main__':
  main()
