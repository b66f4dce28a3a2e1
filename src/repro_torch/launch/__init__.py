"""repro_torch.launch — device meshes for serving (the SR half of the JAX
package's ``launch/mesh.py``) and the LM serving entry point
(``python -m repro_torch.launch.serve``)."""

from repro_torch.launch.mesh import (
    SR_BAND_AXIS,
    SR_REPLICA_AXIS,
    SRMesh,
    band_submesh,
    make_sr_mesh,
)

__all__ = ["SRMesh", "make_sr_mesh", "band_submesh", "SR_REPLICA_AXIS", "SR_BAND_AXIS"]
