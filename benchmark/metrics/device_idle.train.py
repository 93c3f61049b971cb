"""Share of the profiled window in which no device operation runs, %."""
from benchmark.lib import readers


def read(rec):
  return readers.device_idle_pct(rec)
