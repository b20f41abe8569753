"""The port's measuring scripts (counterparts of the repository's
`tools/` scripts of the JAX package), each run as
`python -m tpu_restir_torch.tools.<name>`."""
