"""Launchers, ported from ``repro/launch``: device meshes on
``torch.distributed`` (:mod:`.mesh`), the training loop on one device or
a mesh (:mod:`.train`), and the dry-run (:mod:`.dryrun`), which counts
each cell's step on a fake 256- or 512-rank mesh for the roofline terms of
:mod:`.analysis`."""
from .mesh import (MeshShape, data_axis_size, make_mesh,
                   make_production_mesh)
