"""The learner's StageClock `learning_ms` (GAE and the update, CUDA events
on the stream), averaged over the window's iterations, ms."""
from benchmark.lib import readers


def read(rec):
  return readers.clock_mean_ms(rec, 'learning_ms')
