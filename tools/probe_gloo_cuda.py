#!/usr/bin/env python3
"""Which gloo operations take CUDA tensors, on this machine's card: two gloo
ranks on cuda:0 try point-to-point (isend/irecv), all_reduce, all_gather
and broadcast on CUDA tensors, each in its own pair of processes (a crash
or hang there ends only that probe). Prints one JSON line per operation:
ok, or the error. parallel/collectives.py stages every gloo collective on
a CUDA tensor through host memory whatever this says; the probe records
why.

    python3 tools/probe_gloo_cuda.py
"""
import json
import os
import socket
import sys

OPS = ("p2p", "all_reduce", "all_gather", "broadcast")


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, op, port, q):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        t = torch.full((1024,), float(rank + 1), device="cuda")
        if op == "p2p":
            if rank == 0:
                dist.isend(t, 1).wait()
                want = 1.0
            else:
                dist.irecv(t, 0).wait()
                want = 1.0
        elif op == "all_reduce":
            dist.all_reduce(t)
            want = 3.0
        elif op == "all_gather":
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t)
            t = parts[1]
            want = 2.0
        else:
            dist.broadcast(t, 0)
            want = 1.0
        torch.cuda.synchronize()
        ok = bool((t == want).all())
        q.put((rank, "ok" if ok else f"wrong values {t[:4].tolist()}"))
    except Exception as e:  # the finding itself
        q.put((rank, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"))
    finally:
        dist.destroy_process_group()


def main() -> int:
    import multiprocessing as mp
    import torch
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: needs a card", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    for op in OPS:
        q = ctx.Queue()
        port = _port()
        ps = [ctx.Process(target=_rank, args=(r, op, port, q))
              for r in range(2)]
        for p in ps:
            p.start()
        for p in ps:
            p.join(timeout=120)
        codes = []
        for p in ps:
            if p.is_alive():
                p.kill()
                codes.append("hung")
            else:
                codes.append(p.exitcode)
        res = {}
        while not q.empty():
            r, msg = q.get()
            res[r] = msg
        print(json.dumps({"op": op, "exitcodes": codes, "ranks": res}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
