"""Multi-GPU and multi-host training support — the port of
fast_nnunet_tpu/parallel/distributed.py.

The JAX package trains as one multi-controller program: every host runs the
same jitted step over a mesh whose ``data`` axis spans all global devices,
and XLA inserts the reductions. The port runs one process (a rank) per GPU
under ``torch.distributed``, as the reference does with ``mp.spawn`` +
NCCL: :func:`spawn` starts ``num_gpus`` local ranks, rank ``process_id *
num_gpus + local_rank`` of a world of ``num_hosts * num_gpus``, each on
``cuda:{local_rank}``. The collectives the JAX step gets from its shardings
are explicit here (parallel/collectives.py).

Backends follow the device: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``.
A caller may ask for ``gloo`` on ``cuda`` explicitly (``backend="gloo"``):
then ranks may share a card (local rank r on ``cuda:{r % device_count}``),
which NCCL refuses; collectives on CUDA tensors then stage through host
memory (parallel/collectives.py). Nothing falls back: a failed NCCL init
raises, and ``num_gpus`` above the visible cards raises under NCCL.
"""
import socket
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The backend a device's ranks use: ``nccl`` on the card, else
    ``gloo``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Idempotent ``init_process_group``: a process whose group is already
    up keeps it. ``coordinator_address`` is ``host:port`` (or a full
    ``tcp://`` URL) of rank 0's store; without one the group reads
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` from the
    environment (``env://``, as torchrun sets them). ``backend`` None means
    ``nccl``, the card's."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend or "nccl", init_method=init_method,
                            world_size=-1 if num_processes is None
                            else int(num_processes),
                            rank=-1 if process_id is None else int(process_id))


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def data_group():
    """The group the training step reduces over: the world when there is
    more than one rank, else None (this process alone)."""
    return dist.group.WORLD if world_size() > 1 else None


def local_batch_and_oversample(global_batch_size: int,
                               oversample_percent: float,
                               process_id: int,
                               num_processes: int) -> Tuple[int, float]:
    """Split the global batch over ranks and give each rank the oversample
    fraction matching its slice of the deterministic global rule "the last
    round(bs * oversample) samples of the batch are fg-forced" (ref
    nnUNetTrainer._set_batch_size_and_oversample semantics: global behavior
    must not depend on the number of workers)."""
    base, rem = divmod(global_batch_size, num_processes)
    sizes = [base + (1 if r < rem else 0) for r in range(num_processes)]
    my_start = sum(sizes[:process_id])
    my_end = my_start + sizes[process_id]
    first_fg = round(global_batch_size * (1 - oversample_percent))
    n_fg = max(0, my_end - max(first_fg, my_start))
    local_bs = sizes[process_id]
    return local_bs, n_fg / max(1, local_bs)


def free_port() -> int:
    """A free TCP port on this host for rank 0's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, fn: Callable, args: tuple, kwargs: dict,
               num_gpus: int, num_hosts: int, process_id: int,
               coordinator: str, backend: str, device_type: str,
               results) -> None:
    """One spawned rank: its card, its process group, ``fn``, teardown."""
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    initialize_distributed(coordinator, num_hosts * num_gpus,
                           process_id * num_gpus + local_rank, backend)
    try:
        results.put((local_rank, fn(*args, **kwargs)))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, num_gpus: int, *, device="cuda",
          backend: Optional[str] = None, num_hosts: int = 1,
          coordinator_address: Optional[str] = None, process_id: int = 0,
          args: tuple = (), kwargs: Optional[dict] = None) -> list:
    """Run ``fn(*args, **kwargs)`` on ``num_gpus`` spawned local ranks of
    a world of ``num_hosts * num_gpus`` and return their results (which
    must pickle) in local-rank order. Each host runs this with its own
    ``process_id`` and the same ``coordinator_address`` (``host:port`` of
    process 0); one host with no address takes a free local port. On
    ``cuda`` each rank runs on ``cuda:{local_rank}`` (``resolve_device``
    gives every rank its own card); ``backend`` defaults to the device's
    (:func:`backend_for`). A rank's exception is re-raised here."""
    from ..device import resolve_device
    dev = resolve_device(device)
    backend = backend or backend_for(dev)
    if num_gpus < 1 or num_hosts < 1:
        raise ValueError(f"num_gpus {num_gpus}, num_hosts {num_hosts}")
    if dev.type == "cuda" and backend == "nccl" and \
            num_gpus > torch.cuda.device_count():
        raise ValueError(
            f"-num_gpus {num_gpus} but torch.cuda.device_count() is "
            f"{torch.cuda.device_count()}: NCCL takes one rank per card")
    if coordinator_address is None:
        if num_hosts > 1:
            raise ValueError("-num_hosts > 1 needs -coordinator host:port "
                             "(process 0's address) on every host")
        coordinator_address = f"127.0.0.1:{free_port()}"
    if not 0 <= process_id < num_hosts:
        raise ValueError(f"-process_id {process_id} outside [0, {num_hosts})")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    pc = mp.start_processes(
        _rank_main, args=(fn, tuple(args), dict(kwargs or {}), num_gpus,
                          num_hosts, process_id, coordinator_address,
                          backend, dev.type, results),
        nprocs=num_gpus, join=False, start_method="spawn")
    out = {}
    while True:  # drain while joining: a full pipe would block a rank
        done = pc.join(timeout=0.2)
        while not results.empty():
            r, value = results.get()
            out[r] = value
        if done:
            break
    return [out.get(r) for r in range(num_gpus)]
