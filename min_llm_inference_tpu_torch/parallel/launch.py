"""Start and end the process groups of a dp x tp mesh (what ``jax.devices()``
and one controller give the JAX package).

``run_ranks(fn, world_size, args)`` runs ``fn(*args)`` once in each of
``world_size`` fresh interpreters (spawned, never forked), one rank each,
after ``torch.distributed.init_process_group`` has joined them, and returns
the ranks' results in rank order. The children import torch and this
package only, so ``fn`` must be a module-level function of an importable
module (the workers of parallel/workers.py), and ``args`` must pickle.

  * rendezvous: a file in a fresh temporary directory (never a fixed TCP
    port, so that concurrent meshes on one host cannot collide);
  * rank devices: ``cuda:{rank}`` under NCCL when each rank has a card of
    its own; every rank on ``cuda:0`` under gloo only when the caller asks
    for it (``share_device=True``); ``cpu`` under gloo only when asked
    (``device="cpu"``), with one intra-op thread per rank;
  * failure: the process group has a timeout (PG_TIMEOUT: a rank whose
    peers stopped entering collectives raises after it), the parent joins
    against a deadline (``timeout``): a rank that fails, or a mesh that
    outlives the deadline, ends every rank and raises here with the tail
    of each failed rank's log.

Run as ``python -m min_llm_inference_tpu_torch.parallel.launch DIR RANK``
it is the child side of run_ranks (nothing else calls it that way).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

import torch

_CHILD_MODULE = "min_llm_inference_tpu_torch.parallel.launch"
# seconds a rank waits in a collective for peers that stopped entering it
PG_TIMEOUT = 120.0
# the device of this process's rank, set by the child side of run_ranks
_RANK_DEVICE = None


def rank_device() -> torch.device:
    """This rank's device as run_ranks placed it; raises outside a rank."""
    if _RANK_DEVICE is None:
        raise RuntimeError("not inside a rank started by run_ranks")
    return _RANK_DEVICE


def placement(world_size: int, device: str = "cuda",
              share_device: bool = False) -> tuple:
    """(backend, device of rank 0 .. world_size-1) of a mesh."""
    if device == "cpu":
        return "gloo", [torch.device("cpu")] * world_size
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the mesh on the CPU")
    if share_device:
        return "gloo", [torch.device("cuda", 0)] * world_size
    n = torch.cuda.device_count()
    if world_size > n:
        raise ValueError(f"{world_size} ranks need {world_size} cards, "
                         f"{n} present (share_device=True puts every rank "
                         "on cuda:0 under gloo)")
    return "nccl", [torch.device("cuda", r) for r in range(world_size)]


def _tail(path: str, n: int) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_ranks(fn, world_size: int, args: tuple = (), *, device: str = "cuda",
              share_device: bool = False, timeout: float = 600.0) -> list:
    """fn(*args) on every rank of a ``world_size`` mesh; returns the list
    of the ranks' results. Raises if a rank fails or the mesh is not done
    within ``timeout`` seconds (every rank is ended first)."""
    if fn.__module__ == "__main__":
        raise ValueError("fn must live in an importable module, not in the "
                         "script that calls run_ranks")
    backend, devices = placement(world_size, device, share_device)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        payload = dict(module=fn.__module__, name=fn.__qualname__, args=args,
                       world_size=world_size, backend=backend,
                       devices=[str(d) for d in devices],
                       init_file=os.path.join(tmp, "rendezvous"))
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        procs = []
        try:
            for rank in range(world_size):
                log = open(os.path.join(tmp, f"rank-{rank}.log"), "wb")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", _CHILD_MODULE, tmp, str(rank)],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
                log.close()
            deadline = time.monotonic() + timeout

            def logs(ranks, n):
                return "\n".join(
                    f"--- rank {r} (exit {procs[r].poll()}) ---\n"
                    + _tail(os.path.join(tmp, f"rank-{r}.log"), n)
                    for r in ranks)

            while True:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes):
                    time.sleep(0.5)  # let a peer's own error land too
                    raise RuntimeError("mesh rank(s) failed:\n" + logs(
                        [r for r, p in enumerate(procs)
                         if p.poll() not in (None, 0)], 4000))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mesh of {world_size} ranks not done in {timeout} "
                        "s:\n" + logs(range(world_size), 1500))
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"result-{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _child(tmp: str, rank: int) -> None:
    """One rank: join the group, run the payload's function, write its
    result (or the traceback to the log), leave the group and exit."""
    import torch.distributed as dist

    global _RANK_DEVICE
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        p = pickle.load(f)
    dev = torch.device(p["devices"][rank])
    _RANK_DEVICE = dev
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        p["backend"], init_method="file://" + p["init_file"],
        world_size=p["world_size"], rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT))
    try:
        fn = importlib.import_module(p["module"])
        for part in p["name"].split("."):
            fn = getattr(fn, part)
        result = fn(*p["args"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with open(os.path.join(tmp, f"result-{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(tmp, f"result-{rank}.pkl.tmp"),
                   os.path.join(tmp, f"result-{rank}.pkl"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        # a failed rank leaves without the group's teardown, which would
        # wait for peers that may never come
        os._exit(1)
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without the interpreter's teardown too: after the atexit
    # hooks it was seen to abort about one gloo rank in 70 ("terminate
    # called without an active exception"), its result already written
    os._exit(0)


if __name__ == "__main__":
    # the package's module object, not this __main__ copy, holds the rank
    # device that rank_device() reads
    from min_llm_inference_tpu_torch.parallel import launch as _launch

    _launch._child(sys.argv[1], int(sys.argv[2]))
