"""mjlab_torch: the PyTorch/CUDA port of mjlab_tpu for NVIDIA Hopper GPUs.

The batched physics engine lives in `mjlab_torch.physics`; its hand-written
CUDA kernels and their dispatch in `mjlab_torch.ops`; the robot and scene
builders in `mjlab_torch.asset_zoo`.
"""
