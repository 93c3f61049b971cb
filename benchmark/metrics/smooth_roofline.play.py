"""K3's share of its roofline, %: the least time of one call's work (frozen
k3_work) over the device time of that call."""
from benchmark.lib import readers

ENTRIES = readers.SMOOTH
CAPTURE = ['entry.smooth']


def read(rec):
  return readers.roofline_pct(rec, 'entry.smooth', readers.k3_work)
