"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch code for the ReSTIR frame, the NEE path tracer and the gradient
through the ReSTIR frame, with an intersection (`render/intersect.py`) and
a scene build (`scene/scene.py`) of its own. It imports nothing of the
port or of JAX, and takes only the scene generator's raw arrays."""
