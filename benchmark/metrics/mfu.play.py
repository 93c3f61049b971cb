"""The whole step's share of the card's float32 peak, %: the FLOPs the
window's algorithm needs (frozen kernel work and network widths) over the
profiled window's time."""
from benchmark.lib import readers

ENTRIES = {**readers.SMOOTH, **readers.NEWTON, **readers.PD_SOLVE}
CAPTURE = ['entry.smooth', 'entry.newton', 'entry.pd_solve']


def read(rec):
  return readers.mfu_pct(rec)
