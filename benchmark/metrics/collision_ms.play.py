"""Device time per env-step of the kernels launched inside the port's
collision entry, ms."""
from benchmark.lib import readers

ENTRIES = readers.COLLISION


def read(rec):
  return readers.device_ms_per_step(rec, 'entry.collision')
