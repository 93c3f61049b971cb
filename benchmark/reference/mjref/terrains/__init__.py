"""Terrain subsystem: procedural sub-terrains rasterized into one
heightfield, the importer that lays env origins over the (level, type)
grid, and the default rough grids (counterpart of mjlab_tpu/terrains).
Nothing here imports mujoco: the generator compiles its heightfield only
when it is built into a spec."""

from mjref.terrains.config import (
    ROUGH_TERRAINS_CFG,
    ROUGH_TERRAINS_WITH_HF_CFG,
)
from mjref.terrains.generator import (
    TerrainGenerator,
    TerrainGeneratorCfg,
)
from mjref.terrains.importer import TerrainImporter, TerrainImporterCfg
from mjref.terrains.sub_terrains import (
    BoxFlatTerrainCfg,
    BoxInvertedPyramidStairsTerrainCfg,
    BoxPyramidStairsTerrainCfg,
    BoxRandomGridTerrainCfg,
    FlatTerrainCfg,
    HfInvertedPyramidSlopedTerrainCfg,
    HfPyramidSlopedTerrainCfg,
    HfRandomUniformTerrainCfg,
    HfWaveTerrainCfg,
    SubTerrainCfg,
)

__all__ = [
    'ROUGH_TERRAINS_CFG',
    'ROUGH_TERRAINS_WITH_HF_CFG',
    'TerrainGenerator',
    'TerrainGeneratorCfg',
    'TerrainImporter',
    'TerrainImporterCfg',
    'BoxFlatTerrainCfg',
    'BoxInvertedPyramidStairsTerrainCfg',
    'BoxPyramidStairsTerrainCfg',
    'BoxRandomGridTerrainCfg',
    'FlatTerrainCfg',
    'HfInvertedPyramidSlopedTerrainCfg',
    'HfPyramidSlopedTerrainCfg',
    'HfRandomUniformTerrainCfg',
    'HfWaveTerrainCfg',
    'SubTerrainCfg',
]
