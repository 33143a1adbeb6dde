"""Run several gloo ranks of the PyTorch port in one process, one thread
each, over one in-process store: the CPU stand-in for a multi-rank
``torchrun`` world (no process spawn)."""

import threading
import time

import torch
import torch.distributed as dist

from pytorch_distributed_nn_tpu_torch.parallel.mesh import new_group


def run_ranks(n, fn, timeout=120.0):
    """[fn(rank, group) for each rank], the ranks running concurrently on
    their own gloo groups; re-raises the first rank's exception. The
    ranks get ``timeout`` seconds in all, and so does each gloo
    collective: a rank left waiting on one that failed raises within that
    time instead of keeping its thread in gloo for the groups' default
    600 s."""
    store = dist.HashStore()
    results, errors = [None] * n, [None] * n

    def one(r):
        try:
            group = new_group(dist.PrefixStore("test", store), r, n,
                              torch.device("cpu"), timeout_s=timeout)
            results[r] = fn(r, group)
        except BaseException as e:  # reported to the caller below
            errors[r] = e

    threads = [threading.Thread(target=one, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    for e in errors:
        if e is not None:
            raise e
    return results
