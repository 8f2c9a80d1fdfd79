"""Device compute primitives (segment reduction)."""

from force2vec_tpu.ops.segment import segment_sum_into_batch

__all__ = ["segment_sum_into_batch"]
