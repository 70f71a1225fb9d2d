"""Process groups, meshes, collectives and the CPU launcher of the port's
multi-rank engines.

Port of auto_oo_tpu/parallel/distributed.py.  The JAX package stitches
every host's chips into one global device list and lets XLA emit the
collectives; here each rank is one process with one device, the mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` (one process group per
named axis), and every engine calls the collectives below itself:

    JAX                      PyTorch (this module)
    all_gather(tiled)        all_gather   -> all_gather_into_tensor
    psum_scatter(tiled)      reduce_scatter -> reduce_scatter_tensor
    all_to_all(tiled)        all_to_all   -> all_to_all_single
    psum                     all_reduce   -> all_reduce

The backend follows the device, with no fallback from one to the other:
NCCL for ``cuda``, gloo for ``cpu``.  Every collective is issued at any
group size, one rank included, so a one-rank run on the card goes through
NCCL.  ``COLLECTIVES`` counts the calls and the bytes of their input
buffers per kind.

``initialize_distributed`` reads torchrun's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) or explicit arguments and is a
no-op in a single process with nothing set; ``run_ranks`` is the CPU
counterpart of the JAX package's virtual 8-device mesh: it spawns N gloo
ranks of this machine, rendezvous through a ``FileStore`` (no ports),
one torch thread per rank, and returns what each rank's function
returned.  The workers import only the module of the function they run
(and torch), never JAX.
"""

import contextlib
import os
import pickle
import shutil
import tempfile
import time
import traceback
import warnings
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import config

#: per kind of collective: [calls, bytes of the input buffers]
COLLECTIVES = {"all_gather": [0, 0], "reduce_scatter": [0, 0],
               "all_to_all": [0, 0], "all_reduce": [0, 0]}


def reset_collectives():
    for v in COLLECTIVES.values():
        v[0] = v[1] = 0


def backend_for(device):
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    dev = config.get_device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for {dev}")


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           device=None):
    """Initialize the default process group (idempotent).

    ``coordinator_address`` "host:port" rendezvous over TCP there; without
    it, torchrun's environment (MASTER_ADDR, MASTER_PORT) through its
    ``env://`` store.  ``num_processes`` and ``process_id`` default to
    WORLD_SIZE and RANK, ``local_device_ids`` to LOCAL_RANK, the card of
    this rank (on the card it becomes the current CUDA device).  The
    backend follows ``device`` (the port's default device): NCCL on the
    card, gloo on the CPU.  Returns True when it initialized a group,
    False when one exists or when nothing asks for one (a single process
    with nothing set).  A multi-process run without a coordinator raises
    ValueError."""
    if dist.is_initialized():
        return False
    num_processes = (num_processes if num_processes is not None
                     else _env_int("WORLD_SIZE"))
    process_id = process_id if process_id is not None else _env_int("RANK")
    local = (local_device_ids if local_device_ids is not None
             else _env_int("LOCAL_RANK"))
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif os.environ.get("MASTER_ADDR"):
        # torchrun's store (its agent may already serve MASTER_PORT)
        init_method = "env://"
    elif num_processes in (None, 1):
        return False
    else:
        raise ValueError("a multi-process run needs a coordinator_address "
                         "(or MASTER_ADDR and MASTER_PORT)")
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(local or 0))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes or 1),
                            rank=int(process_id or 0))
    return True


def _one_rank_group(device=None):
    """A group of this process alone, NCCL on the card and gloo on the CPU,
    through an in-process store (no port, no file)."""
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(config.get_device(device).index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def global_mesh(names=("dp", "tp"), shape=None, device=None):
    """A DeviceMesh over every rank of the default group (set up by
    ``initialize_distributed``, or a one-rank group when none exists);
    ``shape`` None puts all ranks on the last axis."""
    if not dist.is_initialized():
        _one_rank_group(device)
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(names) - 1) + (n,)
    return init_device_mesh(config.get_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


class Axis:
    """One named axis of a DeviceMesh as an engine sees it: its process
    group, its size and this rank's place on it."""

    def __init__(self, mesh, name):
        if name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, no "
                             f"{name!r}")
        self.name = name
        self.group = mesh.get_group(name)
        self.size = dist.get_world_size(self.group)
        self.rank = mesh.get_local_rank(name)

    def block(self, n):
        """(rows per rank, this rank's [lo, hi)) of n rows padded to a
        multiple of the axis size."""
        per = -(-n // self.size)
        return per, (self.rank * per, (self.rank + 1) * per)


@contextlib.contextmanager
def _quiet():
    # torch 2.13 marks the *_tensor collectives deprecated (FutureWarning);
    # the card's torch has no other names for them
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _count(kind, x):
    COLLECTIVES[kind][0] += 1
    COLLECTIVES[kind][1] += x.numel() * x.element_size()


def _real(x):
    return torch.view_as_real(x) if x.is_complex() else x


def all_gather(x, axis):
    """The axis' blocks of x concatenated on the leading dim, in rank
    order (JAX's all_gather(tiled=True) on axis 0)."""
    x = x.contiguous()
    out = x.new_empty((axis.size * x.shape[0],) + tuple(x.shape[1:]))
    _count("all_gather", x)
    with _quiet():
        dist.all_gather_into_tensor(_real(out), _real(x), group=axis.group)
    return out


def reduce_scatter(x, axis):
    """This rank's block of the leading dim of the sum of x over the axis
    (JAX's psum_scatter(tiled=True) on axis 0); the leading dim must
    divide by the axis size."""
    x = x.contiguous()
    if x.shape[0] % axis.size:
        raise ValueError(f"reduce_scatter of {x.shape[0]} rows over "
                         f"{axis.size} ranks")
    out = x.new_empty((x.shape[0] // axis.size,) + tuple(x.shape[1:]))
    _count("reduce_scatter", x)
    with _quiet():
        dist.reduce_scatter_tensor(_real(out), _real(x), group=axis.group)
    return out


def all_to_all(x, axis):
    """Block j of x's leading dim goes to rank j; block i of the result
    came from rank i (JAX's all_to_all(tiled=True), split and concat on
    axis 0)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("all_to_all", x)
    dist.all_to_all_single(_real(out), _real(x), group=axis.group)
    return out


def all_reduce(x, axis):
    """The sum of x over the axis, in place (JAX's psum); returns x."""
    if not x.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor")
    _count("all_reduce", x)
    dist.all_reduce(_real(x), group=axis.group)
    return x


# ---- the CPU launcher ------------------------------------------------------


def _worker(rank, nprocs, store_path, out_dir, fn, args):
    torch.set_num_threads(1)
    config.set_device("cpu")
    store = dist.FileStore(store_path, nprocs)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=nprocs,
                            timeout=timedelta(seconds=300))
    try:
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs, *args, timeout=600.0):
    """Run ``fn(rank, *args)`` on ``nprocs`` spawned CPU processes joined
    in one gloo group (the CPU counterpart of a multi-card run) and return
    the list of their results, in rank order.  ``fn`` and ``args`` must
    pickle (a module-level function of a module that imports no JAX);
    results travel back through files in a temporary directory, which is
    removed.  Each worker runs one torch thread with the port's device
    set to the CPU.  A failed rank raises RuntimeError with its
    traceback; ranks still running after ``timeout`` seconds are killed
    and raise TimeoutError."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="auto_oo_ranks_")
    try:
        ctx = mp.start_processes(
            _worker, args=(nprocs, os.path.join(tmp, "store"), tmp, fn,
                           args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks still running "
                                       f"after {timeout} s")
        except mp.ProcessRaisedException as exc:
            raise RuntimeError(f"a rank failed:\n{exc}") from None
        except mp.ProcessExitedException as exc:
            errs = [open(os.path.join(tmp, f)).read()
                    for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
            raise RuntimeError(f"a rank exited: {exc}\n"
                               + "\n".join(errs)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        results = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
