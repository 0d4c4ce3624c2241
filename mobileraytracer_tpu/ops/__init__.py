from . import intersect  # noqa: F401

from .. import constants as C


def build_accelerator(scene, config):
    """Returns `scene` with the acceleration structure `config.accelerator`
    asks for attached in its `bvh` slot: the block BVH (ops/block_bvh.py)
    for ACC_BVH, the regular grid (ops/grid.py) for ACC_REGULAR_GRID, and
    the scene unchanged for the naive scan.  A scene that already carries
    the requested structure is returned as is."""
    if config.accelerator == C.ACC_BVH:
        from . import block_bvh
        if isinstance(scene.bvh, block_bvh.BlockGrid):
            return scene
        return block_bvh.build(scene)
    if config.accelerator == C.ACC_REGULAR_GRID:
        from . import grid
        if isinstance(scene.bvh, grid.RegularGrid):
            return scene
        return grid.build_grid(scene)
    return scene
