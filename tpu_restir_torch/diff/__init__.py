"""Differentiable rendering: pixel-loss gradients w.r.t. material
parameters through the ReSTIR frame (counterpart of `tpu_restir.diff`)."""

from tpu_restir_torch.diff.params import apply_params, extract_params  # noqa: F401
