# Launch layer of the port (counterpart of repro.launch): the mesh
# factory, the roofline terms, and the dry-run, train and serve launchers
# (``python -m repro_torch.launch.{dryrun,train,serve}``).
from .mesh import make_production_mesh, make_mesh, mesh_info

__all__ = ["make_production_mesh", "make_mesh", "mesh_info"]
