"""G1 velocity task registrations (flat terrain)."""

from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
from mjlab_torch.tasks import registry
from mjlab_torch.tasks.velocity.config.g1.flat_env_cfg import (
    UnitreeG1FlatEnvCfg,
    UnitreeG1FlatEnvCfg_PLAY,
)

registry.register('Mjlab-Velocity-Flat-Unitree-G1',
                  env_cfg_entry_point=UnitreeG1FlatEnvCfg,
                  pretrained_policy=G1_FLAT_POLICY)
registry.register('Mjlab-Velocity-Flat-Unitree-G1-Play',
                  env_cfg_entry_point=UnitreeG1FlatEnvCfg_PLAY,
                  pretrained_policy=G1_FLAT_POLICY)
