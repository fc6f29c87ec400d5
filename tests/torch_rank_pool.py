"""A pool of gloo ranks for the port's parallel tests.

:class:`RankPool` spawns ``world`` CPU processes that join one gloo group
(``init_method=file://<tmp>/store``: a fixed ``MASTER_PORT`` would collide
between test files running side by side) and then run whatever function
the test sends them, all ranks at once, returning each rank's result. A
test file starts one pool in a module fixture and runs its cases in it;
``close`` stops and joins every process. The functions must be importable
by the children (module-level, in a module that does not import JAX).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback


def _serve(rank: int, world: int, store: str, timeout_s: float,
           conn) -> None:
    import torch
    torch.set_num_threads(1)
    from jimm_tpu_torch.parallel.mesh import (initialize_distributed,
                                              shutdown_distributed)
    initialize_distributed(num_processes=world, process_id=rank,
                           device="cpu", backend="gloo",
                           init_method=f"file://{store}", timeout_s=timeout_s)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    finally:
        shutdown_distributed()
        conn.close()


class RankPool:
    """``world`` gloo ranks serving calls (see the module docstring).
    ``timeout``: how long a call may take; ``dist_timeout_s``: the group's
    collective timeout."""

    def __init__(self, world: int, tmp_dir, *, timeout: float = 120.0,
                 dist_timeout_s: float = 60.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._conns, self._procs = [], []
        store = os.path.join(str(tmp_dir), "store")
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_serve,
                               args=(rank, world, store, dist_timeout_s, child),
                               daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank at once; the results by
        rank. A rank's exception, or a rank that does not answer within the
        timeout, fails the call with every rank's traceback."""
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        out, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(self.timeout):
                errors.append(f"rank {rank}: no answer in {self.timeout} s")
                out.append(None)
                continue
            status, value = conn.recv()
            if status != "ok":
                errors.append(f"rank {rank}:\n{value}")
            out.append(value)
        if errors:
            raise AssertionError("\n".join(errors))
        return out

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
