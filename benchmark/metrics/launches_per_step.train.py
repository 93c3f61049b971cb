"""Device kernels launched inside the env's step function per env-step:
the host-issue load that a CUDA graph or a fusion cuts."""
from benchmark.lib import readers


def read(rec):
  return readers.launches_per_step(rec, 'bench.env_step')
