"""Sharded rendering over a ('px', 'spp') mesh of ``torch.distributed``
ranks (counterpart: ``rustraytrace_tpu/parallel``): pixel blocks on
``px``, sample batches on ``spp``, reduced with ``all_reduce``.  Ported so
far: the mesh and the reference route's sharded pass and contraction,
which ``diff`` runs on; the sharded image loop and the kernel routes'
sharded passes are not ported yet.
"""

from .mesh import Mesh, make_mesh, mesh_axis_sizes
from .render import render_contract_sharded, render_pass_sharded, spp_traced

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_axis_sizes",
    "render_pass_sharded",
    "render_contract_sharded",
    "spp_traced",
]
