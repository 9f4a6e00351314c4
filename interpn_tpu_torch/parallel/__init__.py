"""Device-mesh parallel evaluation (obs-axis data parallelism).

Counterpart of `interpn_tpu/parallel/`, with its `__all__`; the evaluators
return `sharding.Shards`, the per-device results in mesh order.
"""

from .sharding import (
    OBS_AXIS,
    make_mesh,
    obs_sharding,
    pad_to_multiple,
    prepared_evaluator,
    prepared_stack_evaluator,
    replicated,
    shard_obs,
    sharded_evaluator,
)

__all__ = [
    "OBS_AXIS",
    "make_mesh",
    "obs_sharding",
    "pad_to_multiple",
    "prepared_evaluator",
    "prepared_stack_evaluator",
    "replicated",
    "shard_obs",
    "sharded_evaluator",
]
