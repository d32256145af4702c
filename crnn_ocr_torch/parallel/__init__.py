"""Data parallelism (``crnn_ocr_tpu/parallel/``): meshes, batch sharding
and the collectives (``parallel/mesh.py``)."""

from crnn_ocr_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    gather_rows,
    init_process_mesh,
    make_mesh,
    pad_batch_to,
    replicate_state,
    shard_batch,
    shard_stacked_batch,
    spawn_ranks,
)

__all__ = [
    "Mesh",
    "all_reduce",
    "gather_rows",
    "init_process_mesh",
    "make_mesh",
    "pad_batch_to",
    "replicate_state",
    "shard_batch",
    "shard_stacked_batch",
    "spawn_ranks",
]
