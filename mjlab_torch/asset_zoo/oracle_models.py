"""The engine's oracle models of equality constraints, tendons, mocap
bodies, sensors and the convex and mesh colliders, as MJCF and as
committed snapshots.

The JAX package holds its engine to MuJoCo on these models
(tests/test_equality.py, tests/test_tendon.py, tests/test_physics_step.py,
tests/test_collision_pairs.py, tests/test_mesh_collision.py);
the port keeps its own copies of their MJCF here:

- `connect`, `weld`, `joint`: two bodies joined by one equality of that
  type; `fourbar`: a closed four-bar chain (a connect between two hinged
  chains); `mocap_weld`: a free box welded to a mocap target;
- `tendon`: a fixed tendon coupling two hinges and a spatial tendon (a
  cable over three sites) with limits, a deadband spring and dampers, a
  motor on the cable, a free box on the floor; Euler;
- `robot`: a floating base with a two-joint leg on the floor under
  implicitfast, with its 11 sensors of the JAX test and one contact sensor
  of the foot (data found, force and torque, reduce netforce);
- `convex_pile`: nine free solids over a plane, the geoms of the JAX
  collider tests (tests/test_collision_pairs.py, tests/test_mesh_collision
  .py): a sphere, a capsule, two ellipsoids, two cylinders, a box, the
  octahedron mesh and the asymmetric gem mesh, so that its pair table holds
  every collider group of ellipsoids, cylinders and meshes;
- `mesh_drop`: the octahedron dropped on a plane
  (test_mesh_plane_rollout_oracle).

Every model solves with Newton at 30 iterations and 50 linesearch
iterations, as the JAX tests set them (`compile_model`). A host without
mujoco (the GPU machine) loads the snapshots (`oracle_arrays`);

    python -m mjlab_torch.asset_zoo.oracle_models

rewrites them into asset_zoo/data/oracle_<name>_model.npz on a host with
mujoco.
"""

from __future__ import annotations

from pathlib import Path

CONNECT_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body name="A" pos="0 0 1">
      <joint type="free"/>
      <geom type="box" size=".1 .05 .05" mass="1"/>
    </body>
    <body name="B" pos="0.3 0.1 1.2" euler="10 5 0">
      <joint type="free"/>
      <geom type="box" size=".08 .04 .04" mass="0.5"/>
    </body>
  </worldbody>
  <equality>
    <connect body1="A" body2="B" anchor="0.1 0.02 0.03"/>
  </equality>
</mujoco>"""

WELD_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body name="A" pos="0 0 1">
      <joint type="free"/>
      <geom type="box" size=".1 .05 .05" mass="1"/>
    </body>
    <body name="B" pos="0.3 0.1 1.2" euler="10 5 0">
      <joint type="free"/>
      <geom type="box" size=".08 .04 .04" mass="0.5"/>
    </body>
  </worldbody>
  <equality>
    <weld body1="A" body2="B" torquescale="0.7"/>
  </equality>
</mujoco>"""

JOINT_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body name="C" pos="-0.3 0 1">
      <joint name="h1" type="hinge" axis="0 1 0" damping="0.02"/>
      <geom type="capsule" fromto="0 0 0 0.2 0 0" size=".02" mass=".2" contype="0" conaffinity="0"/>
    </body>
    <body name="D" pos="-0.6 0 1">
      <joint name="h2" type="hinge" axis="0 1 0" damping="0.02"/>
      <geom type="capsule" fromto="0 0 0 0.2 0 0" size=".02" mass=".2" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality>
    <joint joint1="h1" joint2="h2" polycoef="0.05 1.5 0.3 0 0"/>
  </equality>
</mujoco>"""

FOURBAR_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body name="crank" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0.2 0 0" size=".02" mass=".3" contype="0" conaffinity="0"/>
      <body name="coupler" pos="0.2 0 0">
        <joint name="j2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size=".02" mass=".3" contype="0" conaffinity="0"/>
      </body>
    </body>
    <body name="rocker" pos="0.4 0 1">
      <joint name="j3" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0.12 0 -0.05" size=".02" mass=".3" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality>
    <connect body1="coupler" body2="rocker" anchor="0.3 0 0"/>
  </equality>
</mujoco>"""

MOCAP_WELD_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body name="target" mocap="true" pos="0.3 0.1 1.2">
      <geom type="sphere" size="0.03" contype="0" conaffinity="0"/>
    </body>
    <body name="box" pos="0.3 0.1 1.0">
      <joint type="free"/>
      <geom type="box" size=".06 .04 .04" mass="0.4"/>
    </body>
  </worldbody>
  <equality>
    <weld body1="target" body2="box" torquescale="1.0"/>
  </equality>
</mujoco>"""

TENDON_XML = """
<mujoco>
  <option timestep="0.002" integrator="Euler" iterations="30"
          ls_iterations="50"/>
  <worldbody>
    <geom type="plane" size="5 5 .1"/>
    <body pos="0 0 0.5">
      <joint name="j1" type="hinge" axis="0 1 0" range="-1.5 1.5"
             damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.2 0 0" mass="0.3"/>
      <site name="s1" pos="0.2 0 0.03"/>
      <body pos="0.2 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" range="-2 2"
               damping="0.05"/>
        <geom type="capsule" size="0.025" fromto="0 0 0 0.15 0 0"
              mass="0.2"/>
        <site name="s2" pos="0.15 0 0.025"/>
      </body>
    </body>
    <site name="anchor" pos="0.1 0 0.8"/>
    <body pos="0.5 0 0.1">
      <freejoint/>
      <geom type="box" size=".05 .05 .05" mass="0.4"/>
    </body>
  </worldbody>
  <tendon>
    <fixed name="couple" limited="true" range="-0.5 0.5" stiffness="2.0"
           damping="0.1">
      <joint joint="j1" coef="1.0"/>
      <joint joint="j2" coef="-0.5"/>
    </fixed>
    <spatial name="cable" limited="true" range="0 0.75" stiffness="10"
             damping="0.2" springlength="0.3 0.5">
      <site site="anchor"/>
      <site site="s1"/>
      <site site="s2"/>
    </spatial>
  </tendon>
  <actuator>
    <motor tendon="cable" gear="1.5" ctrlrange="-5 5" ctrllimited="true"/>
    <position joint="j1" kp="3"/>
  </actuator>
</mujoco>"""

# the sensor robot; `robot_xml(integrator, contact_sensor)` fills it in
ROBOT_XML = """
<mujoco>
  <option timestep="0.002" integrator="{integrator}"/>
  <worldbody>
    <geom type="plane" size="10 10 0.1"/>
    <body name="base" pos="0 0 0.4">
      <freejoint/>
      <geom type="box" size="0.1 0.05 0.03" mass="2"/>
      <site name="imu" pos="0.01 0.02 0.01"/>
      <body name="thigh" pos="0.1 0 0">
        <joint name="hip" type="hinge" axis="0 1 0" range="-1.5 1.5"
               damping="0.5" armature="0.02" frictionloss="0.1"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.2" size="0.03" mass="0.5"/>
        <body name="shin" pos="0 0 -0.2">
          <joint name="knee" type="hinge" axis="0 1 0" range="-2.0 0"
                 damping="0.3" armature="0.01"/>
          <geom type="capsule" fromto="0 0 0 0 0 -0.18" size="0.025" mass="0.3"/>
          <geom name="foot" type="sphere" pos="0 0 -0.2" size="0.03" mass="0.1"
                friction="0.9 0.02 0.001"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="hip" kp="40" kv="2" ctrlrange="-1.5 1.5" forcerange="-30 30"/>
    <position joint="knee" kp="40" kv="2" ctrlrange="-2 0" forcerange="-30 30"/>
  </actuator>
  <sensor>
    <gyro site="imu"/>
    <velocimeter site="imu"/>
    <accelerometer site="imu"/>
    <framepos objtype="site" objname="imu"/>
    <framequat objtype="body" objname="shin"/>
    <framelinvel objtype="body" objname="shin"/>
    <frameangvel objtype="body" objname="shin"/>
    <framezaxis objtype="body" objname="base"/>
    <jointpos joint="hip"/>
    <jointvel joint="knee"/>
    <subtreecom body="base"/>{contact}
  </sensor>
</mujoco>
"""
FOOT_CONTACT = """
    <contact name="foot" geom1="foot" data="found force torque"
             reduce="netforce"/>"""


# the meshes of tests/test_mesh_collision.py: an octahedron and an
# asymmetric 7-vertex convex solid
OCTA = '0.1 0 0  -0.1 0 0  0 0.12 0  0 -0.12 0  0 0 0.08  0 0 -0.08'
GEM = ('0.09 0.02 0  -0.07 0.05 0.01  0.01 -0.08 0.02  -0.02 0.07 -0.03  '
       '0.03 0.01 0.08  -0.01 -0.02 -0.09  0.08 -0.06 0.03')

# the pile's solids, in body order: (name, geom attributes)
PILE_GEOMS = (
    ('sphere', 'type="sphere" size="0.08"'),
    ('capsule', 'type="capsule" size="0.05 0.12"'),
    ('ellipsoid_a', 'type="ellipsoid" size="0.1 0.07 0.05"'),
    ('ellipsoid_b', 'type="ellipsoid" size="0.1 0.07 0.05"'),
    ('cylinder_a', 'type="cylinder" size="0.07 0.1"'),
    ('cylinder_b', 'type="cylinder" size="0.07 0.1"'),
    ('box', 'type="box" size="0.08 0.06 0.05"'),
    ('octa', 'type="mesh" mesh="octa"'),
    ('gem', 'type="mesh" mesh="gem"'),
)


def _pile_xml() -> str:
  bodies = '\n'.join(
      f'    <body name="{name}" pos="{0.3 * (i % 3 - 1):g} '
      f'{0.3 * (i // 3 - 1):g} 0.3">\n'
      f'      <freejoint/>\n      <geom {geom} mass="0.2"/>\n    </body>'
      for i, (name, geom) in enumerate(PILE_GEOMS))
  return f"""
<mujoco>
  <option timestep="0.002"/>
  <asset>
    <mesh name="octa" vertex="{OCTA}"/>
    <mesh name="gem" vertex="{GEM}"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
{bodies}
  </worldbody>
</mujoco>"""


CONVEX_PILE_XML = _pile_xml()

MESH_DROP_XML = f"""
<mujoco>
  <option timestep="0.002" iterations="30" ls_iterations="50">
    <flag eulerdamp="disable"/>
  </option>
  <asset><mesh name="octa" vertex="{OCTA}"/></asset>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.25"><freejoint/>
      <geom type="mesh" mesh="octa" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>"""


def robot_xml(integrator: str = 'implicitfast',
              contact_sensor: bool = True) -> str:
  return ROBOT_XML.format(integrator=integrator,
                          contact=FOOT_CONTACT if contact_sensor else '')


XML = {
    'connect': CONNECT_XML, 'weld': WELD_XML, 'joint': JOINT_XML,
    'fourbar': FOURBAR_XML, 'mocap_weld': MOCAP_WELD_XML,
    'tendon': TENDON_XML, 'robot': robot_xml(),
    'convex_pile': CONVEX_PILE_XML, 'mesh_drop': MESH_DROP_XML,
}
NAMES = tuple(XML)
ITERATIONS, LS_ITERATIONS = 30, 50
# the equality tests run MuJoCo's Newton to its iteration cap (tolerance 0)
ZERO_TOLERANCE = ('connect', 'weld', 'joint', 'fourbar', 'mocap_weld')


def snapshot_path(name: str) -> Path:
  return Path(__file__).parent / 'data' / f'oracle_{name}_model.npz'


def compile_model(xml: str, tolerance: 'float | None' = None):
  """The MjModel of `xml` with the oracle tests' solver options: Newton,
  ITERATIONS iterations, LS_ITERATIONS linesearch iterations, and
  `tolerance` unless it is None (the XML's or MuJoCo's default)."""
  import mujoco
  mj = mujoco.MjModel.from_xml_string(xml)
  mj.opt.solver = mujoco.mjtSolver.mjSOL_NEWTON
  mj.opt.iterations = ITERATIONS
  mj.opt.ls_iterations = LS_ITERATIONS
  if tolerance is not None:
    mj.opt.tolerance = tolerance
  return mj


def oracle_model(name: str):
  """The compiled oracle model `name` (one of NAMES)."""
  return compile_model(XML[name],
                       0.0 if name in ZERO_TOLERANCE else None)


def oracle_arrays(name: str):
  """The committed ModelArrays snapshot of the oracle model `name`."""
  from mjlab_torch.physics.io import ModelArrays
  return ModelArrays.load(snapshot_path(name))


def write_snapshots() -> None:
  """Write the committed snapshot of every oracle model."""
  from mjlab_torch.physics.io import ModelArrays
  for name in NAMES:
    ModelArrays.of(oracle_model(name)).save(snapshot_path(name))


if __name__ == '__main__':
  write_snapshots()
