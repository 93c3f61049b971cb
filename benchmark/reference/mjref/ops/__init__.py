"""Plain versions of the port's kernels' dispatch (frozen copy)."""
