"""Default rough-terrain grids.

Counterpart of mjlab_tpu/terrains/config.py. A 10x20 grid of 8x8 m cells:
40% flat, 30% pyramid stairs, 30% inverted pyramid stairs (the
reference's default mix), and a variant with the heightfield sub-terrains
(slopes, uniform noise, waves) too.
"""

from mjref.terrains.generator import TerrainGeneratorCfg
from mjref.terrains.sub_terrains import (
    BoxFlatTerrainCfg,
    BoxInvertedPyramidStairsTerrainCfg,
    BoxPyramidStairsTerrainCfg,
    HfPyramidSlopedTerrainCfg,
    HfRandomUniformTerrainCfg,
    HfWaveTerrainCfg,
)

ROUGH_TERRAINS_CFG = TerrainGeneratorCfg(
    size=(8.0, 8.0),
    border_width=20.0,
    num_rows=10,
    num_cols=20,
    horizontal_scale=0.1,
    sub_terrains={
        'flat': BoxFlatTerrainCfg(proportion=0.4),
        'pyramid_stairs': BoxPyramidStairsTerrainCfg(
            proportion=0.3,
            step_height_range=(0.0, 0.1),
            step_width=0.3,
            platform_width=3.0,
            border_width=1.0,
        ),
        'pyramid_stairs_inv': BoxInvertedPyramidStairsTerrainCfg(
            proportion=0.3,
            step_height_range=(0.0, 0.1),
            step_width=0.3,
            platform_width=3.0,
            border_width=1.0,
        ),
    },
)

ROUGH_TERRAINS_WITH_HF_CFG = TerrainGeneratorCfg(
    size=(8.0, 8.0),
    border_width=20.0,
    num_rows=10,
    num_cols=20,
    horizontal_scale=0.1,
    sub_terrains={
        'flat': BoxFlatTerrainCfg(proportion=0.2),
        'pyramid_stairs': BoxPyramidStairsTerrainCfg(
            proportion=0.2, step_height_range=(0.0, 0.1),
            step_width=0.3, platform_width=3.0, border_width=1.0),
        'pyramid_stairs_inv': BoxInvertedPyramidStairsTerrainCfg(
            proportion=0.2, step_height_range=(0.0, 0.1),
            step_width=0.3, platform_width=3.0, border_width=1.0),
        'hf_pyramid_slope': HfPyramidSlopedTerrainCfg(
            proportion=0.1, slope_range=(0.0, 0.4),
            platform_width=2.0, border_width=0.25),
        'random_rough': HfRandomUniformTerrainCfg(
            proportion=0.2, noise_range=(0.02, 0.10), noise_step=0.02,
            border_width=0.25),
        'wave': HfWaveTerrainCfg(
            proportion=0.1, amplitude_range=(0.0, 0.2), num_waves=4,
            border_width=0.25),
    },
)
