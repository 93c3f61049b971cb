"""The learner's StageClock `collection_ms` (CUDA events on the stream),
averaged over the window's iterations, ms."""
from benchmark.lib import readers


def read(rec):
  return readers.clock_mean_ms(rec, 'collection_ms')
