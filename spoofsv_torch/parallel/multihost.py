"""Process groups: joining one, spawning one, and each rank's share of a batch.

Port of :mod:`spoofsv_tpu.parallel.multihost` on ``torch.distributed``. A
rank is one process with one device. :func:`initialize_distributed` joins
the group that its arguments or ``torchrun``'s environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) name; in a
single process it does nothing and returns False. :func:`spawn` makes a
group of N ranks from one command: the calling process joins as rank 0 and
starts ranks 1..N−1 as fresh interpreters, each logging to its own file (a
rank that blocks on a full pipe stalls every other rank inside a
collective) and each join bounded by a timeout.

Host-side artifacts (metrics, checkpoints, figures, wavs) are written by
rank 0 only (:func:`is_primary`).
"""

from __future__ import annotations

import datetime
import fcntl
import os
import pickle
import random
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spoofsv_torch import resolve_device
from spoofsv_torch.parallel.mesh import Mesh, make_mesh

#: seconds a collective (and the rendezvous) may wait before it raises
TIMEOUT_S = 600.0
_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` in an NCCL group, the CPU in a
    gloo group (a gloo group on CUDA names its device explicitly)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    return torch.device("cpu")


def _indexed(device: torch.device) -> torch.device:
    """A bare "cuda" as the current CUDA device (``cuda:N``)."""
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None,
                           device=None, timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group that the arguments, or else ``torchrun``'s
    environment, name; returns True when this process is one of several
    ranks. In a single process with neither it does nothing and returns
    False. Safe to call again: a second call returns the first's answer.

    ``backend`` defaults to :func:`default_backend` of ``device`` (default:
    ``cuda:LOCAL_RANK`` if CUDA is available, else the CPU). A failed NCCL
    initialization raises; nothing falls back to gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return False
    world_size = int(world_size if world_size is not None else os.environ["WORLD_SIZE"])
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if init_method is None:
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ['MASTER_PORT']}")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local) if torch.cuda.is_available() else "cpu"
    device = _indexed(torch.device(device))
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return world_size > 1


def is_primary() -> bool:
    """True on the process that owns host-side artifacts (rank 0, or no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_batch_from_local(local_batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's local rows of the global batch, on its device: each rank
    feeds only its own share, and nothing is gathered."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            .to(mesh.device) for k, v in local_batch.items()}


def per_process_batch_size(global_batch_size: int) -> int:
    """This process's share of the global batch (it must divide evenly)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    assert global_batch_size % n == 0, (
        f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


# ----------------------------------------------------------------------------
# Spawning a group from one command
# ----------------------------------------------------------------------------

def visible_devices(device) -> int:
    """How many ranks the host can give a device each: the CUDA devices for a
    card, the host's cores for the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def rank_devices(n: int, device, share: bool = False) -> List[torch.device]:
    """One device for each of ``n`` ranks: ``cuda:0..n−1`` (or ``n`` times
    ``device`` with ``share``, ranks time-sharing one card) or the CPU.
    Raises ``ValueError`` when ``n`` exceeds :func:`visible_devices`."""
    device = _indexed(torch.device(device))
    have = visible_devices(device)
    if n > have and not share:
        raise ValueError(f"a mesh of {n} ranks needs {n} devices; "
                         f"{have} {'CUDA devices are' if device.type == 'cuda' else 'cores are'} "
                         "visible")
    if device.type == "cuda" and not share:
        return [torch.device("cuda", r) for r in range(n)]
    return [device] * n


def _ephemeral_floor() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError):
        return 32768


def reserve_port() -> Tuple[int, Any]:
    """A rendezvous port and the lock that keeps it: a port below the
    kernel's ephemeral range (no outgoing connection is given it) that
    binds now, under an exclusive ``flock`` that other callers of this
    function respect. Close the returned file once the group has formed."""
    rng = random.Random(os.getpid() * 7919 + int.from_bytes(os.urandom(2), "little"))
    floor = min(_ephemeral_floor(), 32768)
    for _ in range(200):
        port = rng.randrange(10000, floor)
        lock = open(os.path.join(tempfile.gettempdir(), f"spoofsv_torch_port_{port}.lock"), "w")
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            with socket.socket() as s:
                s.bind(("localhost", port))
        except OSError:
            lock.close()
            continue
        return port, lock
    raise RuntimeError("no free rendezvous port found")


def cpu_threads(world: int) -> int:
    """Intra-op threads for each of ``world`` CPU ranks: the host's cores
    shared out, so the ranks do not oversubscribe them."""
    return max(1, (os.cpu_count() or 1) // world)


def _fn_ref(fn: Callable) -> Tuple[str, str, str]:
    """How a spawned rank finds ``fn``: (module name or file path, kind,
    qualified name). A function of the main module is found by the name it
    was run under (``python -m``) or by its file (a script, loaded under
    another name so that its ``__main__`` block does not run)."""
    mod = fn.__module__
    if mod == "__main__":
        main = sys.modules["__main__"]
        if getattr(main, "__spec__", None) is not None:
            return main.__spec__.name, "module", fn.__qualname__
        if getattr(main, "__file__", None):
            return os.path.abspath(main.__file__), "file", fn.__qualname__
        raise ValueError(f"{fn!r} is not importable by name")
    return mod, "module", fn.__qualname__


def _resolve(ref: Tuple[str, str, str]) -> Callable:
    import importlib
    import importlib.util

    where, kind, qualname = ref
    if kind == "module":
        obj = importlib.import_module(where)
    else:
        spec = importlib.util.spec_from_file_location("_spoofsv_rank_main", where)
        obj = importlib.util.module_from_spec(spec)
        sys.modules["_spoofsv_rank_main"] = obj
        spec.loader.exec_module(obj)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _follower_main(spec_path: str) -> None:
    """A spawned rank (``python -c`` entry, its output already in its log):
    join the group, run ``fn(mesh, *args, **kwargs)``, save the result with
    ``torch.save``."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    spec["fn"] = _resolve(spec["fn"])
    spec["args"], spec["kwargs"] = pickle.loads(spec["payload"])
    if torch.device(spec["device"]).type == "cpu":
        torch.set_num_threads(cpu_threads(spec["world"]))
    try:
        initialize_distributed(spec["init"], spec["world"], spec["rank"], spec["backend"],
                               spec["device"], spec["timeout_s"])
        result = spec["fn"](make_mesh(spec["world"], spec["device"]), *spec["args"],
                            **spec["kwargs"])
        torch.save(result, spec["result"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Group:
    """A group of ranks this process started (:func:`start_group`): the
    caller is rank 0; :meth:`finish` joins the followers and leaves the
    group."""

    def __init__(self, procs: List[subprocess.Popen], logs: List[str], results: List[str],
                 mesh: Optional[Mesh], timeout_s: float):
        self.procs, self.logs, self.results = procs, logs, results
        self.mesh = mesh
        self.timeout_s = timeout_s
        self.threads = torch.get_num_threads()   # rank 0's, restored by finish

    def tail(self, i: int) -> str:
        """The end of follower ``i``'s (rank ``i+1``'s) log."""
        try:
            with open(self.logs[i]) as f:
                return f.read()[-3000:]
        except OSError:
            return "(no log)"

    def failed(self) -> List[int]:
        return [i for i, p in enumerate(self.procs) if p.poll() not in (None, 0)]

    def finish(self, ok: bool = True) -> List[Any]:
        """Wait for every follower (killing all of them after the timeout, or
        at once when ``ok`` is False: rank 0 failed, so they would wait in a
        collective), leave the group, and return the followers' results.
        Raises if a follower failed."""
        deadline = time.monotonic() + (self.timeout_s if ok else 5.0)
        try:
            for p in self.procs:
                try:
                    p.wait(max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
            if dist.is_initialized():
                dist.destroy_process_group()
            torch.set_num_threads(self.threads)
        bad = [i for i, p in enumerate(self.procs) if p.returncode != 0]
        if ok and bad:
            raise RuntimeError("; ".join(f"rank {i + 1} exited {self.procs[i].returncode}:\n"
                                         f"{self.tail(i)}" for i in bad))
        return [torch.load(p, weights_only=False) if os.path.exists(p) else None
                for p in self.results]


def start_group(n: int, fn: Callable, *args, devices: Optional[Sequence] = None,
                backend: Optional[str] = None, run_dir: Optional[str] = None,
                timeout_s: float = TIMEOUT_S, **kwargs) -> Group:
    """Start ranks 1..n−1, each a fresh interpreter running
    ``fn(mesh, *args, **kwargs)`` on ``devices[r]``, and join the group as
    rank 0 on ``devices[0]`` (None: the cards, ``cuda:0..n−1``; the CPU only
    when named). ``fn`` must be importable by name and its
    arguments picklable; the ranks import only what ``fn`` needs (no
    re-import of the caller's main module, as ``multiprocessing``'s spawn
    would do). Rank ``r`` logs to ``<run_dir>/rank<r>.log``. ``backend``:
    :func:`default_backend` of ``devices[0]`` unless named. A follower that
    exits before the group forms fails the call at once."""
    if devices is None:
        devices = rank_devices(n, resolve_device(None))
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) == 1:
        devices = devices * n
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    backend = backend or default_backend(devices[0])
    run_dir = run_dir or tempfile.mkdtemp(prefix="spoofsv_mesh_")
    os.makedirs(run_dir, exist_ok=True)
    port, lock = reserve_port()
    init = f"tcp://localhost:{port}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    for k in _ENV:
        env.pop(k, None)
    logs = [os.path.join(run_dir, f"rank{r}.log") for r in range(1, n)]
    results = [os.path.join(run_dir, f"rank{r}.pt") for r in range(1, n)]
    procs: List[subprocess.Popen] = []
    group = Group(procs, logs, results, None, timeout_s)
    try:
        for r in range(1, n):
            spec = os.path.join(run_dir, f"rank{r}.spec")
            with open(spec, "wb") as f:
                pickle.dump(dict(init=init, world=n, rank=r, backend=backend,
                                 device=devices[r], timeout_s=timeout_s, fn=_fn_ref(fn),
                                 payload=pickle.dumps((args, kwargs)),
                                 result=results[r - 1]), f)
            with open(logs[r - 1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import sys; from spoofsv_torch.parallel.multihost "
                     "import _follower_main; _follower_main(sys.argv[1])", spec],
                    stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL, env=env))
        # rank 0's rendezvous waits for every follower: wait in a thread and
        # watch the followers, so one that dies fails the call now
        err: List[BaseException] = []

        def join() -> None:
            try:
                initialize_distributed(init, n, 0, backend, devices[0], timeout_s)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                err.append(e)

        th = threading.Thread(target=join, daemon=True)
        th.start()
        while th.is_alive():
            th.join(0.2)
            if group.failed():
                raise RuntimeError(f"rank {group.failed()[0] + 1} exited before the group "
                                   f"formed:\n{group.tail(group.failed()[0])}")
        if err:
            raise err[0]
    except BaseException:
        lock.close()
        group.finish(ok=False)
        raise
    lock.close()
    group.mesh = make_mesh(n, devices[0])
    if group.mesh.device.type == "cpu":
        torch.set_num_threads(cpu_threads(n))
    return group


def spawn(n: int, fn: Callable, *args, devices: Optional[Sequence] = None,
          backend: Optional[str] = None, run_dir: Optional[str] = None,
          timeout_s: float = TIMEOUT_S, **kwargs) -> List[Any]:
    """Run ``fn(mesh, *args, **kwargs)`` on ``n`` ranks (this process is
    rank 0; see :func:`start_group`) and return every rank's result, rank
    order."""
    group = start_group(n, fn, *args, devices=devices, backend=backend, run_dir=run_dir,
                        timeout_s=timeout_s, **kwargs)
    try:
        first = fn(group.mesh, *args, **kwargs)
    except BaseException:
        group.finish(ok=False)
        raise
    return [first] + group.finish()
