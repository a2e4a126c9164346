"""The job launcher: ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N script.py [args]`` (counterpart of
``paddle_tpu/distributed/launch/main.py``).

One process a rank, as Paddle's launcher runs one a GPU: it starts N
processes of ``script.py`` with the rank variables exported —
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` / ``PADDLE_LOCAL_RANK``
/ ``PADDLE_MASTER`` and torch's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` — which ``distributed.init_parallel_env`` reads. It
watches them: the first that exits non-zero has the others terminated
(killed after ``--grace`` seconds), and its exit code becomes the
launcher's (the watcher role of the reference's launcher). ``--nnodes``
/ ``--rank`` place this host's ranks in a larger world (each host runs
its own launcher with the same ``--master``). ``--log_dir`` sends rank
i's output to ``workerlog.i``.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List

__all__ = ["launch"]


def _parse(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch one process a rank of a training job")
    p.add_argument("--master", default=None,
                   help="rendezvous host:port (default: a free port on "
                        "127.0.0.1)")
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of hosts in the job")
    p.add_argument("--rank", type=int, default=0, help="this host's rank")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="ranks (processes) on this host")
    p.add_argument("--devices", default=None,
                   help="CUDA_VISIBLE_DEVICES for every rank")
    p.add_argument("--log_dir", default=None,
                   help="directory for workerlog.<rank>")
    p.add_argument("--grace", type=float, default=10.0,
                   help="seconds between terminating and killing the "
                        "other ranks after a failure")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(args, master: str, local: int) -> dict:
    host, _, port = master.rpartition(":")
    world = args.nproc_per_node * args.nnodes
    rank = args.rank * args.nproc_per_node + local
    env = dict(os.environ)
    env.update(PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM=str(world),
               PADDLE_LOCAL_RANK=str(local),
               PADDLE_LOCAL_SIZE=str(args.nproc_per_node),
               PADDLE_MASTER=master, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(local),
               LOCAL_WORLD_SIZE=str(args.nproc_per_node),
               MASTER_ADDR=host, MASTER_PORT=port)
    if args.devices is not None:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    return env


def _stop(procs: List[subprocess.Popen], grace: float) -> None:
    for q in procs:
        if q.poll() is None:
            q.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace
    for q in procs:
        try:
            q.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            q.kill()
            q.wait()


def _watch(procs: List[subprocess.Popen], grace: float) -> int:
    """The first non-zero exit stops the others and is returned; 0 when
    every rank exits 0."""
    try:
        while True:
            alive = False
            for p in procs:
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    _stop(procs, grace)
                    return rc if rc > 0 else 128 - rc
            if not alive:
                return 0
            time.sleep(0.1)
    except KeyboardInterrupt:
        _stop(procs, grace)
        return 130


def launch(argv=None) -> int:
    args = _parse(argv)
    master = args.master or f"127.0.0.1:{_free_port()}"
    logs = []
    procs = []
    try:
        for local in range(args.nproc_per_node):
            out = None
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
                rank = args.rank * args.nproc_per_node + local
                out = open(os.path.join(args.log_dir, f"workerlog.{rank}"),
                           "w")
                logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, args.training_script,
                 *args.training_script_args],
                env=_rank_env(args, master, local), stdout=out,
                stderr=subprocess.STDOUT if out else None))
        rc = _watch(procs, args.grace)
    finally:
        _stop(procs, args.grace)
        for f in logs:
            f.close()
    if rc != 0:
        print(f"launch: a rank failed with exit code {rc}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(launch())
