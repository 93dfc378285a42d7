"""Spawned gloo ranks for the port's mesh tests (``test_torch_port_parallel.py``,
``test_torch_port_mesh_trainer.py``).

:func:`run_world` starts ``world`` processes (``spawn``: the parent holds
JAX and its threads) that join one gloo process group on localhost, run the
named job of this module with its arguments, and write each rank's result
to a temporary file; the parent gets the results in rank order. A rank that
dies or passes the deadline fails the call. Jobs import the port only, never
JAX: the parent compares with the JAX package.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, job, args, out_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    sys.path[:0] = [ROOT, os.path.dirname(os.path.abspath(__file__))]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    result = None
    try:
        dist.init_process_group("gloo", rank=rank, world_size=world)
        import torch_mesh_jobs

        result = getattr(torch_mesh_jobs, job)(*args)
        dist.barrier()
    except BaseException:
        result = {"error": traceback.format_exc()}
    finally:
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(job: str, world: int, *args, timeout: float = 240.0):
    """Run ``torch_mesh_jobs.<job>(*args)`` on ``world`` gloo ranks; returns
    their results in rank order (raises with a rank's traceback if one
    failed)."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_entry, args=(world, _free_port(), job, args, out_dir),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + timeout
        while not ctx.join(timeout=max(0.1, deadline - time.time())):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"{job} on {world} ranks passed {timeout} s")
        results = [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                   for r in range(world)]
    for r, res in enumerate(results):
        if isinstance(res, dict) and "error" in res:
            raise RuntimeError(f"rank {r} of {job}:\n{res['error']}")
    return results


def rng_array(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
