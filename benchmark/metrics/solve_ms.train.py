"""Device time per env-step of the kernels launched inside the port's
constraint-solve entry (rows to forces, K2 with it), ms."""
from benchmark.lib import readers

ENTRIES = readers.SOLVE


def read(rec):
  return readers.device_ms_per_step(rec, 'entry.solve')
