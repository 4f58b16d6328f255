"""Scale-out layer (counterpart of tpuvof/parallel): device meshes, halo
exchange, the distributed 2-D and 3-D engines (one controller driving one
tensor per shard) on the shard driver and the distributed multigrid they
share, and the mesh planner."""
from .dist import Decomp, admission_2d
from .dist3d import Decomp3D, admission_3d
from .halo import HaloSpec, exchange
from .mesh import Mesh, factor2d, make_mesh
from .mg import MGDecomp, mg_solve_dist
from .plan import MeshPlan, format_plans, plan_mesh_2d, plan_mesh_3d

__all__ = ["Decomp", "Decomp3D", "HaloSpec", "MGDecomp", "Mesh", "MeshPlan", "admission_2d",
           "admission_3d", "exchange", "factor2d", "format_plans", "make_mesh",
           "mg_solve_dist", "plan_mesh_2d", "plan_mesh_3d"]
