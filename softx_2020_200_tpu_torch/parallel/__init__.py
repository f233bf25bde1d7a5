"""Distribution over shards (counterpart of
``softx_2020_200_tpu.parallel``): the Morton element partition
(:mod:`.partition`), and the GLS and GD engines' nonlinear solves over a
list of devices, one process driving every shard (:mod:`.sharded`,
:mod:`.sharded_gd`)."""

from .partition import ShardLayout, partition_space
