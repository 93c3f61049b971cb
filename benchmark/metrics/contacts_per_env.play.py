"""The port's counter contacts_active: mean active contacts of an env at a
collision call in the traced window."""
from benchmark.lib import program_spans


def read(rec):
  return program_spans.contacts_per_env(rec)
