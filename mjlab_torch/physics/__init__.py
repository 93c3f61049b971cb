"""Batched rigid-body physics engine (PyTorch), the counterpart of
mjlab_tpu.physics. Entry points run on the GPU unless the caller passes
device='cpu'."""

from mjlab_torch.physics.io import (
    data_from_numpy,
    make_batched_data,
    make_data,
    model_from_numpy,
    put_model,
)
from mjlab_torch.physics.pipeline import forward, step
from mjlab_torch.physics.types import (
    ConeType,
    Contact,
    Data,
    DisableBit,
    GeomType,
    IntegratorType,
    JointType,
    Model,
    ModelStatic,
    Option,
)

__all__ = ['ConeType', 'Contact', 'Data', 'DisableBit', 'GeomType',
           'IntegratorType', 'JointType', 'Model', 'ModelStatic', 'Option',
           'data_from_numpy', 'forward', 'make_batched_data', 'make_data',
           'model_from_numpy', 'put_model', 'step']
