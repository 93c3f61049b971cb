"""The port's counter resets: mean envs reset at an env-step of the traced
window."""
from benchmark.lib import program_spans


def read(rec):
  return program_spans.resets_per_step(rec)
