"""Parallelism over ranks (port of the sequence-parallel part of
``paddle_tpu/parallel``): the mesh, the collectives over its axes and
ring attention. Tensor, pipeline and expert parallelism, Ulysses and the
quantized collectives are later slices."""
from . import collectives, mesh, ring
from .mesh import (AXES, Mesh, PartitionSpec, axis_size, create_mesh,
                   get_mesh, set_mesh)
from .ring import (active_sequence_parallel, ring_attention,
                   ring_attention_local, sequence_parallel)

__all__ = ["collectives", "mesh", "ring", "AXES", "Mesh", "PartitionSpec",
           "axis_size", "create_mesh", "get_mesh", "set_mesh",
           "active_sequence_parallel", "ring_attention",
           "ring_attention_local", "sequence_parallel"]
