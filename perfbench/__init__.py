"""The benchmark of the PyTorch/CUDA port (`tpu_restir_torch`): one run of
one cell is `python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, as `BENCHMARK.json` at the checkout's root
names the cells. It imports nothing of JAX or of the JAX package."""
