"""Which collectives a process-group backend carries on a device's tensors.

``python -m jimm_tpu_torch.parallel.probe [--backend gloo] [--device cuda]
[--world 2]`` starts ``world`` ranks (all on one card when the device is
CUDA: rank r takes ``cuda:(r % device_count)``) once for each collective
that ``parallel/comm.py`` and FSDP2 issue, runs it on small tensors of that
device, checks the result against the plain answer, and prints one JSON
object: ``{"backend", "device", "world", "torch", "cases": {name: "ok" or
the error}}``. Each case runs in fresh processes with its own file store
and a 60 s group timeout, all cases at once, so one that hangs or breaks
its group does not spoil another. ``comm.HOST_STAGED`` records what this printed on the
card's machine: the collectives that gloo does not carry on CUDA tensors
and that ``comm`` therefore stages through pinned host memory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from datetime import timedelta

#: the collectives probed, in the order printed
CASES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_to_all_single",
         "all_to_all_single_uneven", "batch_isend_irecv", "send_recv",
         "barrier", "fully_shard", "all_reduce_bf16",
         "all_to_all_single_bf16")


def _case(name: str, dev, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist

    def want(got, ref):
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"got {got.cpu().tolist()} want "
                                 f"{ref.tolist()}")

    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    if name == "all_reduce":
        t = x.to(dev)
        dist.all_reduce(t)
        want(t, sum(torch.arange(4.0) + 10 * r for r in range(world)))
    elif name == "broadcast":
        t = x.to(dev)
        dist.broadcast(t, src=0)
        want(t, torch.arange(4.0))
    elif name == "all_gather":
        outs = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(outs, x.to(dev))
        want(torch.cat(outs), torch.cat([torch.arange(4.0) + 10 * r
                                         for r in range(world)]))
    elif name == "all_gather_into_tensor":
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, x.to(dev))
        want(out, torch.cat([torch.arange(4.0) + 10 * r
                             for r in range(world)]))
    elif name == "reduce_scatter_tensor":
        inp = torch.arange(2.0 * world).repeat(1) + rank
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, inp.to(dev))
        full = sum(torch.arange(2.0 * world) + r for r in range(world))
        want(out, full[2 * rank:2 * rank + 2])
    elif name == "all_to_all_single":
        inp = torch.arange(2.0 * world) + 100 * rank
        out = torch.empty(2 * world, device=dev)
        dist.all_to_all_single(out, inp.to(dev))
        want(out, torch.cat([torch.arange(2.0 * rank, 2.0 * rank + 2)
                             + 100 * r for r in range(world)]))
    elif name == "all_to_all_single_uneven":
        # the ring shift as an all-to-all: everything to rank + 1
        dst, src = (rank + 1) % world, (rank - 1) % world
        send = [4 if r == dst else 0 for r in range(world)]
        recv = [4 if r == src else 0 for r in range(world)]
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, x.to(dev), output_split_sizes=recv,
                               input_split_sizes=send)
        want(out, torch.arange(4.0) + 10 * src)
    elif name == "batch_isend_irecv":
        dst, src = (rank + 1) % world, (rank - 1) % world
        out = torch.empty(4, device=dev)
        ops = [dist.P2POp(dist.isend, x.to(dev), dst),
               dist.P2POp(dist.irecv, out, src)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        want(out, torch.arange(4.0) + 10 * src)
    elif name == "send_recv":
        dst, src = (rank + 1) % world, (rank - 1) % world
        out = torch.empty(4, device=dev)
        if rank % 2 == 0:
            dist.send(x.to(dev), dst)
            dist.recv(out, src)
        else:
            dist.recv(out, src)
            dist.send(x.to(dev), dst)
        want(out, torch.arange(4.0) + 10 * src)
    elif name == "all_reduce_bf16":
        t = x.to(dev, torch.bfloat16)
        dist.all_reduce(t)
        want(t.float(), sum(torch.arange(4.0) + 10 * r for r in range(world)))
    elif name == "all_to_all_single_bf16":
        inp = torch.arange(2.0 * world) + 100 * rank
        out = torch.empty(2 * world, device=dev, dtype=torch.bfloat16)
        dist.all_to_all_single(out, inp.to(dev, torch.bfloat16))
        want(out.float(), torch.cat([torch.arange(2.0 * rank, 2.0 * rank + 2)
                                     + 100 * r for r in range(world)]))
    elif name == "barrier":
        dist.barrier()
    elif name == "fully_shard":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
        torch.manual_seed(0)
        model = torch.nn.Linear(8, 8).to(dev)
        fully_shard(model, mesh=mesh)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for _ in range(2):
            loss = model(torch.ones(2, 8, device=dev) * (rank + 1)).sum()
            loss.backward()
            opt.step()
            opt.zero_grad()
        torch.cuda.synchronize() if dev.type == "cuda" else None
    else:
        raise ValueError(f"unknown case {name!r}")


def _rank_main(args) -> int:
    import torch
    import torch.distributed as dist
    dev = torch.device("cpu")
    if args.device == "cuda":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world,
                            timeout=timedelta(seconds=60))
    try:
        _case(args.case, dev, args.rank, args.world)
    finally:
        dist.destroy_process_group()
    return 0


def _start_case(name: str, backend: str, device: str, world: int,
                tmp: str) -> list:
    store = os.path.join(tmp, f"store_{name}")
    return [subprocess.Popen(
        [sys.executable, "-m", "jimm_tpu_torch.parallel.probe", "--rank",
         str(r), "--case", name, "--store", store, "--backend", backend,
         "--device", device, "--world", str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _finish_case(procs: list) -> str:
    errors = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            errors.append("timed out")
            continue
        if p.returncode:
            lines = [ln for ln in out.strip().splitlines() if ln.strip()]
            errors.append(lines[-1][-300:] if lines else f"rc {p.returncode}")
    return "ok" if not errors else errors[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m jimm_tpu_torch.parallel.probe")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--case", default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe --device cuda needs a card")
    with tempfile.TemporaryDirectory() as tmp:
        # every case at once: each has its own processes and store
        started = {c: _start_case(c, args.backend, args.device, args.world,
                                  tmp) for c in args.cases.split(",")}
        cases = {c: _finish_case(procs) for c, procs in started.items()}
    print(json.dumps({"backend": args.backend, "device": args.device,
                      "world": args.world, "torch": torch.__version__,
                      "cases": cases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
