"""Idle device time per env-step while the host is inside a physics.* span
of the port (each gap put down to the span that holds its midpoint), ms:
what a CUDA graph or a fused stage would cut."""
from benchmark.lib import program_spans


def read(rec):
  return program_spans.physics_idle_ms(rec)
