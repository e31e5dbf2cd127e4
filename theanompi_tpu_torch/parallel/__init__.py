"""The BSP planes over ``torch.distributed``, one process per card.

Module names follow ``theanompi_tpu.parallel``: ``bsp`` (the step and
its cadences), ``exchanger`` (the gradient and parameter exchange, its
wires, error feedback and buckets overlapped with the backward),
``partition`` (the byte-balanced plans), ``zero`` (ZeRO-1: the optimizer
state sharded over the ranks) and ``fsdp`` (the parameters sharded
too); and the async rules' in-process planes: ``server`` (the EASGD,
ASGD and GOSGD stores), ``pipe`` (the overlapped exchange) and
``exchanger``'s merge arithmetic; and the transformer family's mesh:
``mesh`` (the five axes as process groups), ``sequence`` (ring,
all-gather and Ulysses attention), ``tensor`` (Megatron's pair),
``pipeline`` (GPipe) and ``expert`` (switch routing).
"""
