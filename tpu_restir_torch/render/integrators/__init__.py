from tpu_restir_torch.render.integrators.naive import render_naive  # noqa: F401
from tpu_restir_torch.render.integrators.nee import render_nee  # noqa: F401
