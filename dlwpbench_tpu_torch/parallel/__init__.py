"""The multi-process layer of the port (counterpart of
`dlwpbench_tpu/parallel/`): one process per rank over `torch.distributed`,
each running explicit code on its shard."""
