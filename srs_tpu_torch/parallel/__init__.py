"""The device mesh (port of ``srs_tpu/parallel/``): ``mesh.py`` (meshes of
``torch.device``s and placement descriptors), ``dispatch.py`` (the tile
dispatcher), ``halo.py`` (the halo-exchange merge and Laplacian blend),
``finalize.py`` (the sharded banded finalize), ``train.py`` (the
mesh-sharded training step, with the ``model`` axis) and ``dryrun.py``
(the multi-device dry run of ``__graft_entry__.dryrun_multichip``)."""

from .dispatch import MeshTileDispatcher
from .halo import sharded_laplacian_blend, sharded_weighted_merge
from .mesh import data_sharding, make_mesh, replicated, spatial_sharding

__all__ = [
    "MeshTileDispatcher",
    "sharded_weighted_merge",
    "sharded_laplacian_blend",
    "make_mesh",
    "data_sharding",
    "spatial_sharding",
    "replicated",
]
