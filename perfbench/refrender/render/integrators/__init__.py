from perfbench.refrender.render.integrators.nee import render_nee  # noqa: F401
