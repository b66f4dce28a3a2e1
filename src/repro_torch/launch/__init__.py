"""repro_torch.launch — device meshes (``launch/mesh.py``: the SR serving
mesh and the LM meshes), the dry-run (``launch/dryrun_lib.py``) and the
entry points (``python -m repro_torch.launch.serve``, ``... .train``,
``... .dryrun``)."""

from repro_torch.launch.mesh import (
    MULTI_POD,
    SINGLE_POD,
    SR_BAND_AXIS,
    SR_REPLICA_AXIS,
    Mesh,
    SRMesh,
    band_submesh,
    make_mesh,
    make_production_mesh,
    make_sr_mesh,
)
from repro_torch.launch.dryrun_lib import pick_rules, run_all, run_cell

__all__ = ["Mesh", "SRMesh", "make_mesh", "make_production_mesh", "make_sr_mesh",
           "band_submesh", "SR_REPLICA_AXIS", "SR_BAND_AXIS", "SINGLE_POD", "MULTI_POD",
           "run_cell", "run_all", "pick_rules"]
