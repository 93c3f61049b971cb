"""Batched rigid-body physics engine in plain PyTorch, the counterpart of
mjlab_tpu.physics for the configured scenes. Entry points run on the GPU
unless the caller passes device='cpu'."""

from mjref.physics.io import (
    make_batched_data,
    make_data,
    model_from_numpy,
    put_model,
)
from mjref.physics.pipeline import forward, step
from mjref.physics.types import (
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
           'forward', 'make_batched_data', 'make_data',
           'model_from_numpy', 'put_model', 'step']
