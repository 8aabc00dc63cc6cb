"""Distributed execution: the process group, data-parallel training with
sync batch norm, the validation gather and batch-sharded serving
(counterpart of `yolov3_tensorflow_tpu/parallel/`).

The JAX package shards a batch over a device mesh inside one program; here
every rank is one process with one device, joined by a
`torch.distributed` process group: NCCL between cards, gloo on the CPU or
where ranks share a card.
"""
