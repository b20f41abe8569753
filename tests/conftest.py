import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped without one")
    # One intra-op thread in every test process. The suite runs under six
    # xdist workers on eight cores, and a PyTorch pool over every core in
    # each worker oversubscribes them: the plain kernel versions' loops of
    # small tensor ops then wait on their pools. test_torch_roofline.py
    # took 787 s under six workers so, 26 s alone on one thread; the CLI
    # golden of test_torch_objloader.py 50-90 s, 1.3 s on one thread.
    # A test that needs more threads sets them itself, with its measured
    # reason. The processes that the dist tests spawn set their own
    # (tests/torch_dist_worker.py).
    torch.set_num_threads(1)
