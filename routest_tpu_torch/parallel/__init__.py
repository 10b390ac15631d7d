"""Sequence, tensor, pipeline and expert parallelism over a mesh.

The counterpart of ``routest_tpu/parallel/``, with the JAX package's
public names. Every program is a per-shard function run by
``core/smap.py``'s ``shard_map`` — its collectives exchange tensors
between the shards, autograd differentiates through them, so the same
code paths train:

- :mod:`routest_tpu_torch.parallel.ring` — ring attention: K/V blocks
  rotate around the ring while each shard accumulates its queries'
  attention with a running softmax;
- :mod:`routest_tpu_torch.parallel.ulysses` — all-to-all sequence
  parallelism: sequence↔heads re-sharding, full attention per head
  shard;
- :mod:`routest_tpu_torch.parallel.tensor` — Megatron column/row tensor
  parallelism over the ``model`` axis (forward, training, serving);
- :mod:`routest_tpu_torch.parallel.pipeline` — GPipe fill-drain
  pipeline parallelism over a ``stage`` axis;
- :mod:`routest_tpu_torch.parallel.expert` — Switch-style expert
  parallelism (capacity-bounded all-to-all MoE dispatch) over an
  ``expert`` axis.
"""

from routest_tpu_torch.parallel.expert import (init_moe_params,
                                               make_moe_apply,
                                               shard_moe_params)
from routest_tpu_torch.parallel.pipeline import (make_pipeline_apply,
                                                 make_pipeline_train_step,
                                                 microbatch,
                                                 shard_stage_params,
                                                 stack_stage_params)
from routest_tpu_torch.parallel.ring import (ring_attention,
                                             ring_attention_sharded)
from routest_tpu_torch.parallel.tensor import (make_tp_apply,
                                               make_tp_train_step,
                                               shard_tp_params)
from routest_tpu_torch.parallel.ulysses import (ulysses_attention,
                                                ulysses_attention_sharded)

__all__ = [
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "make_tp_apply",
    "make_tp_train_step",
    "shard_tp_params",
    "make_pipeline_apply",
    "make_pipeline_train_step",
    "microbatch",
    "stack_stage_params",
    "shard_stage_params",
    "init_moe_params",
    "make_moe_apply",
    "shard_moe_params",
]
