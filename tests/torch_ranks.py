"""Run several gloo ranks of the PyTorch port in one process, one thread
each, over one in-process store: the CPU stand-in for a multi-rank
``torchrun`` world (no process spawn)."""

import threading

import torch
import torch.distributed as dist

from pytorch_distributed_nn_tpu_torch.parallel.mesh import new_group


def run_ranks(n, fn, timeout=120.0):
    """[fn(rank, group) for each rank], the ranks running concurrently on
    their own gloo groups; re-raises the first rank's exception."""
    store = dist.HashStore()
    results, errors = [None] * n, [None] * n

    def one(r):
        try:
            group = new_group(dist.PrefixStore("test", store), r, n,
                              torch.device("cpu"))
            results[r] = fn(r, group)
        except BaseException as e:  # reported to the caller below
            errors[r] = e

    threads = [threading.Thread(target=one, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    for e in errors:
        if e is not None:
            raise e
    return results
