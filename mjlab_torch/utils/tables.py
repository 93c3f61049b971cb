"""Fixed-width ASCII tables for the managers' startup summary.

The port's own copy of mjlab_tpu/utils/tables.py (the reference prints
PrettyTable blocks from every manager; this avoids the dependency)."""

from __future__ import annotations


def format_table(title: str, headers: list, rows: list) -> str:
  cols = [headers] + [[str(c) for c in r] for r in rows]
  widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]
  sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
  out = [title, sep,
         '|' + '|'.join(f' {h:<{w}} ' for h, w in zip(headers, widths))
         + '|', sep]
  for r in cols[1:]:
    out.append('|' + '|'.join(
        f' {c:<{w}} ' for c, w in zip(r, widths)) + '|')
  out.append(sep)
  return '\n'.join(out)


def env_summary(env) -> str:
  """Startup diagnostic block for a ManagerBasedRlEnv."""
  parts = []
  am = env.action_manager
  parts.append(format_table(
      f'Action terms (total dim {am.total_dim})',
      ['term', 'dim'],
      [[n, t.action_dim] for n, t in am.terms.items()]))

  om = env.observation_manager
  for gname, terms in om.groups.items():
    parts.append(format_table(
        f"Observation group '{gname}' (dim {om.group_dim(gname)})",
        ['term', 'dim', 'history', 'noise'],
        [[t.name, t.dim, t.history or '-',
          type(t.cfg.noise).__name__ if t.cfg.noise else '-']
         for t in terms]))

  rm = env.reward_manager
  parts.append(format_table(
      'Reward terms', ['term', 'weight'],
      [[n, t.weight] for n, t in rm.terms.items()]))

  tm = env.termination_manager
  parts.append(format_table(
      'Termination terms', ['term', 'time_out'],
      [[n, t.time_out] for n, t in tm.terms.items()]))

  cm = env.command_manager
  if cm.terms:
    parts.append(format_table(
        'Command terms', ['term', 'dim'],
        [[n, t.dim] for n, t in cm.terms.items()]))

  em = env.event_manager
  rows = ([[n, 'startup'] for n in em.startup_terms]
          + [[n, 'reset'] for n in em.reset_terms]
          + [[n, 'interval'] for n in em.interval_terms])
  if rows:
    parts.append(format_table('Event terms', ['term', 'mode'], rows))

  um = env.curriculum_manager
  if um.terms:
    parts.append(format_table(
        'Curriculum terms', ['term'], [[n] for n in um.terms]))
  return '\n\n'.join(parts)
