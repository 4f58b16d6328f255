"""Scale-out layer (counterpart of tpuvof/parallel): device meshes and the
distributed 3-D engine, one controller driving one tensor per shard."""
from .dist3d import Decomp3D, admission_3d
from .mesh import Mesh, factor2d, make_mesh

__all__ = ["Decomp3D", "Mesh", "admission_3d", "factor2d", "make_mesh"]
