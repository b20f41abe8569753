"""tpu_restir_torch: the ReSTIR renderer of `tpu_restir`, in PyTorch.

A port of the JAX package beside it, module for module, for one NVIDIA
H100. Plain tensor code is PyTorch; the Pallas TPU kernels on the path
become CUDA kernels under `csrc/`, built at first CUDA use
(`tpu_restir_torch.kernels.build`). Every kernel keeps a plain PyTorch
version in its module, taken only for tensors that lie on the CPU.

Nothing here imports JAX or the JAX package: the config dataclasses
(`tpu_restir_torch.config`, the same fields as `tpu_restir.config`) and
the image exporter (`tpu_restir_torch.io.export`) are the port's own
copies. Every function that makes a tensor takes the device it is given:
there is no automatic device pick; the CLI renders on --device (cuda by
default) and raises where it is missing.
"""

__version__ = "0.1.0"

from tpu_restir_torch.config import (  # noqa: F401
    CameraConfig,
    IntersectorConfig,
    RenderConfig,
    RenderParams,
    RestirParams,
)
from tpu_restir_torch.scene.cornell import cornell_box  # noqa: F401
from tpu_restir_torch.scene.scene import SceneArrays, build_scene  # noqa: F401
