"""The general code of the benchmark of ``iou3dmatch_tpu_torch``: the
manifest, the traffic generator, the seeded weights, the shapes, FLOPs and
kernel calls of a step, the trace reader, the comparison that decides
``correct`` and the drivers that a traffic mix names."""
