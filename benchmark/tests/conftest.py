"""The benchmark's CPU tests: the harness is importable from the
repository root, the frozen reference (`mjref`) beside it."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (ROOT, os.path.join(ROOT, 'benchmark', 'reference')):
  if path not in sys.path:
    sys.path.insert(0, path)
