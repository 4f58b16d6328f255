"""Scale-out layer (counterpart of tpuvof/parallel): device meshes, the
distributed 3-D engines (one controller driving one tensor per shard) and
the distributed multigrid they and a 2-D decomposition share."""
from .dist3d import Decomp3D, admission_3d
from .mesh import Mesh, factor2d, make_mesh
from .mg import MGDecomp, mg_solve_dist

__all__ = ["Decomp3D", "MGDecomp", "Mesh", "admission_3d", "factor2d", "make_mesh",
           "mg_solve_dist"]
