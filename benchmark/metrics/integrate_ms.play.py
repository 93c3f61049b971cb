"""Device time per env-step of the operations launched inside the port's
span physics.integrate (the integrator, K1 with it), ms."""
from benchmark.lib import program_spans


def read(rec):
  return program_spans.stage_ms(rec, 'integrate')
