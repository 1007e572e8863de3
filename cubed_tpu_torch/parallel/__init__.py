"""The device mesh, the rings and attention (counterpart of
``cubed_tpu/parallel``). The reference's ``multihost`` exports
(``dcn_mesh``, ``host_chunk_assignment``, ``local_chunks``) wait for ROADMAP
Queue 1 item 12b."""

from .attention import attention  # noqa: F401
from .mesh import factorized_mesh, make_mesh, reshard, sharding_for_chunks  # noqa: F401
