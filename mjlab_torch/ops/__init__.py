"""Hand-written CUDA kernels of the port and their dispatch: K1 pd_solve,
K2 newton, K3 smooth_kernel, K4 contact_rows. `LAUNCHES` counts each
kernel's launches."""

from mjlab_torch.ops._build import LAUNCHES, build_all, reset_launches

__all__ = ['LAUNCHES', 'build_all', 'reset_launches']
