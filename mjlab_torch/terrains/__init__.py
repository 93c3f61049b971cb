"""Terrain subsystem: procedural sub-terrains rasterized into one
heightfield, the importer that lays env origins over the (level, type)
grid, and the default rough grids (counterpart of mjlab_tpu/terrains)."""
