"""Launchers, ported from ``repro/launch``: device meshes on
``torch.distributed`` (:mod:`.mesh`) and the training loop on one device
or a mesh (:mod:`.train`).  The dry-run and analysis launchers wait for
the next slice (``ROADMAP.md`` queue 1)."""
from .mesh import (MeshShape, data_axis_size, make_mesh,
                   make_production_mesh)
