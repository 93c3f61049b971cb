"""Device time per env-step of the operations launched inside the port's
span physics.constraint (make_efc: the constraint rows), ms."""
from benchmark.lib import program_spans


def read(rec):
  return program_spans.stage_ms(rec, 'constraint')
