"""Viewer stack of the port: the BaseViewer playback engine, the native
MuJoCo viewer, the optional viser web viewer, the offscreen renderer of
device trajectories and the debug visualizers.

Counterpart of mjlab_tpu/viewer. Every module imports without mujoco,
viser and imageio; each imports them where it draws."""

from mjlab_torch.viewer.base import BaseViewer, EnvProtocol, PolicyProtocol
from mjlab_torch.viewer.debug_visualizer import (
    DebugVisualizer,
    MujocoSceneVisualizer,
    NullVisualizer,
)
from mjlab_torch.viewer.native import NativeMujocoViewer, run_viewer
from mjlab_torch.viewer.offscreen import render_trajectory, scene_mj_model

__all__ = [
    'BaseViewer',
    'DebugVisualizer',
    'EnvProtocol',
    'MujocoSceneVisualizer',
    'NativeMujocoViewer',
    'NullVisualizer',
    'PolicyProtocol',
    'render_trajectory',
    'run_viewer',
    'scene_mj_model',
]
