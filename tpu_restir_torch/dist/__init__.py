"""Row-sharded rendering over torch.distributed (counterpart of
`tpu_restir.dist`): the row mesh (`mesh`), the halo exchange and its
all-gather fallback (`halo`), the sharded ReSTIR step and the row split
and gather of its state (`sharded`), and sharded value_and_grad with
all-reduced material gradients (`diff`)."""
