"""Motion preprocessing: qpos trajectories -> the motion .npz of tracking.

Counterpart of mjlab_tpu/scripts/motion.py. Input trajectories (CSV rows of
base pose and joint positions, or programmatic qpos) are resampled to the
control rate (lerp, and slerp for quaternions), replayed through forward
kinematics to the world poses of the robot's bodies, and differentiated
(finite differences; the SO(3) log for angular velocity) into the arrays
MotionLoader reads: joint_pos, joint_vel, body_pos_w, body_quat_w,
body_lin_vel_w, body_ang_vel_w. The body axis is the robot's body order.

Where the JAX package runs CPU MuJoCo's `mj_kinematics` frame by frame on
the robot compiled alone, the port runs its own `physics.kinematics` once
on all frames of the trajectory, in float64, on the compiled scene's
snapshot (asset_zoo/data/g1_tracking_model.npz by default; the robot under
the prefix `robot/`), so it needs no mujoco package. Only the robot's
collision geoms count for the ground clearance: the scene's plane is not
the robot's.

    python -m mjlab_torch.scripts.motion --synthetic-squat --output squat.npz
    python -m mjlab_torch.scripts.motion --csv walk.csv --output walk.npz

Runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import numpy as np
import torch

# Bump when the G1 robot description or the synthetic-motion recipe
# changes: cached npz files embed robot body poses.
G1_MOTION_VERSION = 3
PREFIX = 'robot/'


def _quat_slerp_np(q0, q1, t):
  d = np.sum(q0 * q1, axis=-1, keepdims=True)
  q1 = np.where(d < 0, -q1, q1)
  d = np.abs(d).clip(-1, 1)
  theta = np.arccos(d)
  sin_t = np.sin(theta)
  w0 = np.where(sin_t > 1e-6,
                np.sin((1 - t) * theta) / np.maximum(sin_t, 1e-12), 1 - t)
  w1 = np.where(sin_t > 1e-6, np.sin(t * theta) / np.maximum(sin_t, 1e-12),
                t)
  q = w0 * q0 + w1 * q1
  return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _quat_log(q):
  """Rotation vector of unit quaternion (w, x, y, z)."""
  q = np.where(q[..., :1] < 0, -q, q)
  sin_half = np.linalg.norm(q[..., 1:], axis=-1)
  angle = 2.0 * np.arctan2(sin_half, q[..., 0])
  axis = q[..., 1:] / np.maximum(sin_half, 1e-12)[..., None]
  return np.where((sin_half > 1e-8)[..., None], axis * angle[..., None],
                  2.0 * q[..., 1:])


def _quat_mul_np(a, b):
  aw, ax, ay, az = np.moveaxis(a, -1, 0)
  bw, bx, by, bz = np.moveaxis(b, -1, 0)
  return np.stack([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw], -1)


def _quat_conj_np(q):
  return q * np.array([1.0, -1, -1, -1])


def resample_qpos(qpos: np.ndarray, in_fps: float, out_fps: float,
                  quat_cols: 'list[int]') -> np.ndarray:
  """Resample a (T, nq) trajectory to out_fps; slerp quaternion columns."""
  T = qpos.shape[0]
  dur = (T - 1) / in_fps
  n_out = int(np.floor(dur * out_fps)) + 1
  t_out = np.arange(n_out) / out_fps * in_fps
  i0 = np.clip(np.floor(t_out).astype(int), 0, T - 1)
  i1 = np.clip(i0 + 1, 0, T - 1)
  a = (t_out - i0)[:, None]
  out = qpos[i0] * (1 - a) + qpos[i1] * a
  for qc in quat_cols:
    out[:, qc:qc + 4] = _quat_slerp_np(
        qpos[i0, qc:qc + 4], qpos[i1, qc:qc + 4], a)
  return out


def _tracking_scene():
  from mjlab_torch.asset_zoo import tracking_arrays
  return tracking_arrays()


def _robot(mj_model):
  from mjlab_torch.entity.entity import compute_indexing
  return compute_indexing(mj_model, PREFIX)


def _kinematics(mj_model, qpos_traj: np.ndarray, device):
  """The port's forward kinematics of every frame of `qpos_traj` at once,
  in float64 on `device`."""
  import mjlab_torch.physics as phys
  from mjlab_torch.physics.kinematics import kinematics
  m = phys.put_model(mj_model, device=device, dtype=torch.float64)
  d = phys.make_batched_data(m, qpos_traj.shape[0], device=device)
  d = d.replace(qpos=torch.as_tensor(qpos_traj, dtype=torch.float64,
                                     device=m.device))
  return kinematics(m, d)


def qpos_to_motion(mj_model, body_ids, joint_q_adr: np.ndarray,
                   qpos_traj: np.ndarray, fps: float,
                   device='cuda') -> dict:
  """Replay a (T, nq) qpos trajectory of the compiled scene `mj_model` (a
  ModelArrays or mujoco.MjModel) through forward kinematics; the motion
  arrays of the bodies `body_ids` (global ids, in order)."""
  d = _kinematics(mj_model, qpos_traj, device)
  ids = torch.as_tensor(np.asarray(body_ids), device=d.qpos.device)
  body_pos = d.xpos[:, ids].cpu().numpy()
  body_quat = d.xquat[:, ids].cpu().numpy()

  dt = 1.0 / fps
  joint_pos = qpos_traj[:, joint_q_adr]
  joint_vel = np.gradient(joint_pos, dt, axis=0)
  body_lin_vel = np.gradient(body_pos, dt, axis=0)
  # angular velocity via SO(3) log of relative rotation (world frame)
  dq = _quat_mul_np(body_quat[1:], _quat_conj_np(body_quat[:-1]))
  ang = _quat_log(dq) / dt
  body_ang_vel = np.concatenate([ang[:1], ang], axis=0)
  return dict(joint_pos=joint_pos.astype(np.float32),
              joint_vel=joint_vel.astype(np.float32),
              body_pos_w=body_pos.astype(np.float32),
              body_quat_w=body_quat.astype(np.float32),
              body_lin_vel_w=body_lin_vel.astype(np.float32),
              body_ang_vel_w=body_ang_vel.astype(np.float32))


def project_ground_clearance(mj_model, qpos: np.ndarray, root_z_adr: int,
                             geom_ids, clearance: float = 0.002,
                             device='cuda') -> None:
  """Lift each frame's root so that the lowest surface point of the
  collision geoms among `geom_ids` (the robot's) sits at `clearance` above
  z = 0 (in place). Hand-authored kinematic motions do not keep the feet
  on the floor exactly; frames that dip collision geoms below the plane
  would make RSI resets start deeply penetrated."""
  from mjlab_torch.physics.types import GeomType
  g = np.asarray(geom_ids)
  g = g[(np.asarray(mj_model.geom_contype)[g] != 0)
        | (np.asarray(mj_model.geom_conaffinity)[g] != 0)]
  typ = np.asarray(mj_model.geom_type)[g]
  known = (int(GeomType.SPHERE), int(GeomType.CAPSULE), int(GeomType.BOX))
  if not np.isin(typ, known).all():
    raise NotImplementedError(
        f'ground clearance of geom types {sorted(set(typ) - set(known))}: '
        'the port bounds spheres, capsules and boxes')
  d = _kinematics(mj_model, qpos, device)
  ids = torch.as_tensor(g, device=d.qpos.device)
  xz = d.geom_xpos[:, ids, 2]
  R2 = d.geom_xmat[:, ids, 2, :].abs()  # |row z| of each geom's frame
  size = torch.as_tensor(np.asarray(mj_model.geom_size)[g],
                         dtype=torch.float64, device=xz.device)
  t = torch.as_tensor(typ, device=xz.device)
  z = torch.where(
      t == int(GeomType.SPHERE), xz - size[:, 0],
      torch.where(t == int(GeomType.CAPSULE),
                  xz - R2[..., 2] * size[:, 1] - size[:, 0],
                  xz - (R2 * size).sum(-1)))
  zmin = z.min(dim=1).values.cpu().numpy()
  qpos[:, root_z_adr] += np.maximum(0.0, clearance - zmin)


def csv_to_npz(csv_path: str, output_path: str, input_fps: float = 30.0,
               output_fps: float = 50.0, mj_model=None,
               device='cuda') -> str:
  """CSV rows = [base_pos(3), base_quat(4, wxyz), joint_pos(nj)] -> npz, on
  the robot of the compiled scene `mj_model` (default: the G1 tracking
  scene)."""
  mj = _tracking_scene() if mj_model is None else mj_model
  idx = _robot(mj)
  raw = np.loadtxt(csv_path, delimiter=',')
  qpos = np.zeros((raw.shape[0], mj.nq))
  qpos[:, idx.free_q_adr] = raw[:, :7]
  qpos[:, idx.q_adr] = raw[:, 7:]
  qpos = resample_qpos(qpos, input_fps, output_fps,
                       quat_cols=[int(idx.free_q_adr[3])])
  motion = qpos_to_motion(mj, idx.body_ids, idx.q_adr, qpos, output_fps,
                          device=device)
  np.savez(output_path, **motion)
  return output_path


def _home_joints(idx) -> np.ndarray:
  from mjlab_torch.asset_zoo.unitree_g1 import HOME_KEYFRAME
  from mjlab_torch.utils.string import resolve_matching_names_values
  base = np.zeros(len(idx.joint_names))
  ids, _, vals = resolve_matching_names_values(HOME_KEYFRAME.joint_pos,
                                               idx.joint_names)
  base[ids] = vals
  return base


def generate_g1_walk_csv(csv_path: str, duration_s: float = 10.0,
                         fps: float = 30.0, gait_hz: float = 1.2,
                         turn_deg_s: float = 30.0, device='cuda') -> str:
  """Author a synthetic G1 walk-and-turn clip as a raw CSV in the
  retargeting input format (rows = [base_pos(3), base_quat(4, wxyz),
  joint_pos(29)]): straight, a 90-degree left turn, straight again, with
  alternating leg swings, knee flexion during swing, ankle compensation and
  arm counter-swing; feet kept clear of the plane by
  project_ground_clearance."""
  from mjlab_torch.asset_zoo.unitree_g1 import HOME_KEYFRAME
  mj = _tracking_scene()
  idx = _robot(mj)
  names = list(idx.joint_names)
  T = int(duration_s * fps)
  t = np.arange(T) / fps
  joint = np.tile(_home_joints(idx), (T, 1))
  j = {n: i for i, n in enumerate(names)}

  # gait phases: left leg leads, right leg half a cycle behind
  phase = 2 * np.pi * gait_hz * t
  swing_amp, knee_amp = 0.22, 0.35
  for side, ph in (('left', phase), ('right', phase + np.pi)):
    s, c = np.sin(ph), np.cos(ph)
    joint[:, j[f'{side}_hip_pitch_joint']] = -0.1 - swing_amp * s
    joint[:, j[f'{side}_knee_joint']] = 0.3 + knee_amp * np.maximum(c, 0.0)
    joint[:, j[f'{side}_ankle_pitch_joint']] = (
        -0.2 + swing_amp * s - knee_amp * np.maximum(c, 0.0) * 0.5)
  joint[:, j['left_shoulder_pitch_joint']] = 0.2 + 0.15 * np.sin(phase)
  joint[:, j['right_shoulder_pitch_joint']] = 0.2 - 0.15 * np.sin(phase)

  # heading: straight 40%, left turn to 90 deg, straight again
  turn_rate = np.zeros(T)
  t0, t1 = 0.4 * duration_s, 0.4 * duration_s + 90.0 / turn_deg_s
  turn_rate[(t >= t0) & (t < t1)] = np.deg2rad(turn_deg_s)
  yaw = np.cumsum(turn_rate) / fps

  # forward speed consistent with the leg swing (stride ~= 2 L sin(A))
  leg_len = 0.6
  speed = 2.0 * leg_len * np.sin(swing_amp) * gait_hz
  heading = np.stack([np.cos(yaw), np.sin(yaw)], -1)
  pos_xy = np.cumsum(speed * heading / fps, axis=0)

  fq = idx.free_q_adr
  qpos = np.zeros((T, mj.nq))
  qpos[:, fq[0]:fq[0] + 2] = pos_xy
  # slight vertical bob at twice the gait frequency
  qpos[:, fq[2]] = HOME_KEYFRAME.pos[2] - 0.02 * (1 - np.cos(2 * phase)) * 0.5
  qpos[:, fq[3]] = np.cos(yaw / 2)  # w
  qpos[:, fq[6]] = np.sin(yaw / 2)  # z
  qpos[:, idx.q_adr] = joint
  project_ground_clearance(mj, qpos, int(fq[2]), idx.geom_ids,
                           device=device)

  rows = np.concatenate([qpos[:, fq[0]:fq[0] + 3], qpos[:, fq[3]:fq[3] + 4],
                         qpos[:, idx.q_adr]], axis=1)
  np.savetxt(csv_path, rows, delimiter=',')
  return csv_path


def generate_g1_squat_motion(output_path: str, duration_s: float = 8.0,
                             fps: float = 50.0, device='cuda') -> str:
  """Synthetic squat + arm-swing reference motion for the G1 (kinematic),
  used where motion-capture data is unavailable."""
  from mjlab_torch.asset_zoo.unitree_g1 import HOME_KEYFRAME
  from mjlab_torch.utils.string import resolve_matching_names_values
  mj = _tracking_scene()
  idx = _robot(mj)
  T = int(duration_s * fps)
  t = np.arange(T) / fps
  fq = idx.free_q_adr

  qpos = np.zeros((T, mj.nq))
  phase = 2 * np.pi * 0.5 * t  # 0.5 Hz squat
  # 0..0.22 m commanded dip; the ground-clearance projection lifts frames
  # whose feet would sink
  depth = 0.22 * 0.5 * (1 - np.cos(phase))
  qpos[:, fq[0]] = 0.0
  qpos[:, fq[2]] = HOME_KEYFRAME.pos[2] - depth
  qpos[:, fq[3]] = 1.0  # identity quat

  joint = np.tile(_home_joints(idx), (T, 1))

  def set_j(pattern, values):
    ids, _, _ = resolve_matching_names_values({pattern: 0.0},
                                              idx.joint_names)
    for i in ids:
      joint[:, i] = values

  # crouch kinematics: hip/knee/ankle follow the squat depth
  set_j('.*_hip_pitch_joint', -0.1 - 2.4 * depth)
  set_j('.*_knee_joint', 0.3 + 4.2 * depth)
  set_j('.*_ankle_pitch_joint', -0.2 - 1.8 * depth)
  swing = 0.3 * np.sin(phase)
  set_j('left_shoulder_pitch_joint', 0.2 + swing)
  set_j('right_shoulder_pitch_joint', 0.2 - swing)
  qpos[:, idx.q_adr] = joint

  project_ground_clearance(mj, qpos, int(fq[2]), idx.geom_ids,
                           device=device)
  motion = qpos_to_motion(mj, idx.body_ids, idx.q_adr, qpos, fps,
                          device=device)
  np.savez(output_path, **motion)
  return output_path


def main(argv=None):
  """csv_to_npz CLI: CSV rows of [base_pos(3), base_quat(4 wxyz),
  joint_pos(nj)] -> MotionLoader npz, or a built-in synthetic G1 motion."""
  import argparse
  import os
  parser = argparse.ArgumentParser(description=__doc__,
                                   formatter_class=argparse.
                                   RawDescriptionHelpFormatter)
  parser.add_argument('--csv', default=None, help='input CSV trajectory')
  parser.add_argument('--output', required=True, help='output npz path')
  parser.add_argument('--robot', default='g1', choices=('g1', 'go1', 'tiny'),
                      help="the scene's robot the CSV drives (default g1)")
  parser.add_argument('--input-fps', type=float, default=30.0)
  parser.add_argument('--output-fps', type=float, default=50.0)
  parser.add_argument('--synthetic-squat', action='store_true',
                      help='generate the synthetic G1 squat instead of '
                      'reading a CSV')
  parser.add_argument('--synthetic-walk', action='store_true',
                      help='author the synthetic G1 walk-and-turn clip as '
                      'a CSV next to --output and run it through csv_to_npz')
  parser.add_argument('--render', default=None, metavar='MP4',
                      help='not ported yet (ROADMAP 12.7, 12.10)')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  if args.render:
    raise SystemExit('--render: rendering is not ported yet '
                     '(ROADMAP 12.7, 12.10)')

  if args.robot == 'g1':
    mj = _tracking_scene()
  elif args.robot == 'go1':
    from mjlab_torch.asset_zoo import go1_flat_arrays
    mj = go1_flat_arrays()
  else:
    from mjlab_torch.asset_zoo import tiny_flat_arrays
    mj = tiny_flat_arrays()
  if (args.synthetic_squat or args.synthetic_walk) and args.robot != 'g1':
    parser.error('the synthetic motions are G1 motions; use --robot g1')
  if args.synthetic_squat:
    generate_g1_squat_motion(args.output, fps=args.output_fps,
                             device=args.device)
  elif args.synthetic_walk:
    csv_path = os.path.splitext(args.output)[0] + '.csv'
    generate_g1_walk_csv(csv_path, fps=args.input_fps, device=args.device)
    print(f'wrote {csv_path}')
    csv_to_npz(csv_path, args.output, args.input_fps, args.output_fps,
               mj_model=mj, device=args.device)
  elif args.csv:
    csv_to_npz(args.csv, args.output, args.input_fps, args.output_fps,
               mj_model=mj, device=args.device)
  else:
    parser.error('provide --csv, --synthetic-squat or --synthetic-walk')
  print(f'wrote {args.output}')
  return args.output


if __name__ == '__main__':
  main()
