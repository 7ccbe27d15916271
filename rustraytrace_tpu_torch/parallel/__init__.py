"""Sharded rendering over a ('px', 'spp') mesh of ``torch.distributed``
ranks (counterpart: ``rustraytrace_tpu/parallel``): pixel blocks on
``px``, sample batches on ``spp``, reduced with ``all_reduce``.  The mesh
(``mesh.py``), the reference route's sharded pass and contraction, which
``diff`` runs on, the sharded router and image loop (``render.py``), the
kernel routes' sharded passes (``megakernel.py``) and the multi-process
bring-up and CPU jobs (``multihost.py``).
"""

from .mesh import Mesh, make_mesh, mesh_axis_sizes
from .render import (render_contract_sharded, render_image_sharded,
                     render_pass_sharded, resolve_sharded_backend,
                     spp_traced)
from .megakernel import (megakernel_shard_eligible,
                         render_image_sharded_megakernel,
                         render_pass_megakernel_sharded,
                         render_pass_wavefront_sharded,
                         sharded_megakernel_wiring, spp_traced_mesh,
                         wavefront_shard_eligible)
from .multihost import (global_mesh, initialize, make_assemble,
                        render_image_multihost, run_cpu_ranks)

__all__ = [
    "make_mesh",
    "mesh_axis_sizes",
    "render_pass_sharded",
    "render_image_sharded",
    "megakernel_shard_eligible",
    "render_pass_megakernel_sharded",
    "render_image_sharded_megakernel",
    "Mesh",
    "render_contract_sharded",
    "spp_traced",
    "resolve_sharded_backend",
    "wavefront_shard_eligible",
    "render_pass_wavefront_sharded",
    "sharded_megakernel_wiring",
    "spp_traced_mesh",
    "initialize",
    "global_mesh",
    "make_assemble",
    "render_image_multihost",
    "run_cpu_ranks",
]
