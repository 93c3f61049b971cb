"""mjref: a frozen plain copy of the port's engine, managers, tasks and
learner, the reference that the benchmark holds the port to.

It was copied from `mjlab_torch` when the benchmark was defined and cut to
what the configured cells' checks drive: one process, the G1 velocity
tasks on their pinned snapshot (benchmark/reference/data), the plain
versions of the port's kernels in torch (K3 `plain_all`, K2
`newton_plain`, K1 `linalg.solve_pd`), the colliders, constraint rows and
sensors of the G1 flat and rough scenes, and the learner's forward, GAE
and update. A model or a cfg outside that raises. It imports nothing of
`mjlab_torch` and reads none of its files: later changes to the port do
not reach it.
"""
