"""Device time per env-step of the operations launched inside the port's
span physics.kinematics (K3, or kinematics, com_pos and crb), ms."""
from benchmark.lib import program_spans


def read(rec):
  return program_spans.stage_ms(rec, 'kinematics')
