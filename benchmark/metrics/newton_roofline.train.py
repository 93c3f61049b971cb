"""K2's share of its roofline, %: the least time of one call's work (frozen
newton_work, its Newton steps counted by the frozen plain Newton on that
call's inputs) over the device time of that call."""
from benchmark.lib import readers

ENTRIES = readers.NEWTON
CAPTURE = ['entry.newton']


def read(rec):
  return readers.roofline_pct(rec, 'entry.newton', readers.k2_work)
