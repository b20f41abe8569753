"""Which torch.distributed operations a gloo group accepts on CUDA tensors.

    python3 tools/gloo_cuda_probe.py

For each operation, two ranks on cuda:0 join a gloo group over localhost
in fresh processes and run it once on a CUDA tensor of known values; the
line printed says whether it returned the right values, gave wrong ones,
raised (with the error's first line), or killed the process. The port's
row mesh (tpu_restir_torch/dist/mesh.py) stages every gloo buffer of a
CUDA rank through host memory whatever this prints.
"""

import subprocess
import sys

_RANK = r"""
import sys, torch, torch.distributed as dist
op, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
dev = torch.device("cuda:0")
x = torch.full((4,), float(rank + 1), device=dev)
if op == "all_reduce":
    dist.all_reduce(x)
    ok = torch.equal(x.cpu(), torch.full((4,), 3.0))
elif op == "all_gather_into_tensor":
    out = torch.empty(8, device=dev)
    dist.all_gather_into_tensor(out, x)
    ok = torch.equal(out.cpu(), torch.tensor([1.0] * 4 + [2.0] * 4))
else:
    peer = 1 - rank
    got = torch.empty(4, device=dev)
    if op == "send_recv":
        if rank == 0:
            dist.send(x, peer)
            dist.recv(got, peer)
        else:
            dist.recv(got, peer)
            dist.send(x, peer)
    else:
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                         dist.P2POp(dist.irecv, got, peer)]):
            w.wait()
    ok = torch.equal(got.cpu(), torch.full((4,), float(peer + 1)))
print("OK" if ok else "WRONG VALUES", flush=True)
dist.destroy_process_group()
"""


def probe(op: str, port: int) -> str:
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, op, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            results.append("timed out")
            continue
        if p.returncode == 0:
            results.append(out.strip())
        elif p.returncode < 0:
            results.append(f"killed by signal {-p.returncode}")
        else:
            lines = [ln for ln in err.strip().splitlines() if ln.strip()]
            results.append("raised: " + (lines[-1] if lines else "?"))
    return "; ".join(f"rank {r}: {v}" for r, v in enumerate(results))


def main():
    import torch
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}")
    for i, op in enumerate(("all_reduce", "all_gather_into_tensor",
                            "send_recv", "batch_isend_irecv")):
        print(f"gloo {op} on CUDA tensors: {probe(op, 29650 + i)}",
              flush=True)


if __name__ == "__main__":
    main()
