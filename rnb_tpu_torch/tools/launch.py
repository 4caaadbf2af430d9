"""Launch one command as several processes of one run.

Each process gets the three variables of the reference's multi-process
launch (``rnb_tpu_torch/parallel/distributed.py``):
``RNB_TPU_COORDINATOR=127.0.0.1:<port>`` (a port free when the launch
starts), ``RNB_TPU_NUM_PROCESSES`` and its own ``RNB_TPU_PROCESS_ID``,
and the checkout on ``PYTHONPATH``; :func:`launch`'s ``env_of`` gives
one process variables of its own (a fault plan in one process only, as
``RNB_FAULT_PLAN``). The processes start together (none is forked from a
process that touched CUDA) and must all end within the timeout: past
it, or as soon as one exits non-zero and the others do not end within
:data:`GRACE_S`, every one left is killed, so a launch never outlives
its caller.

    python3 -m rnb_tpu_torch.tools.launch -n 2 [--timeout S] -- \\
        python3 -c 'from rnb_tpu_torch.parallel import distributed; ...'

A served run of a launch is the benchmark's CLI in every process: each
serves the whole config and writes its own job directory (``-p<index>``
appended to the job's name), and the config's mesh stage spans the
processes (``rnb_tpu_torch.config``). :func:`launch_copy` makes such a
config from a one-process one, in memory:

    python3 -m rnb_tpu_torch.tools.launch -n 2 -- python3 -m \\
        rnb_tpu_torch.benchmark -c COPY.json -mi 0 -v 32 --seed 0
"""

from __future__ import annotations

import argparse
import copy
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: seconds the other processes of a launch may run on after one failed
GRACE_S = 30.0


class Ended(NamedTuple):
    """How one process of a launch ended: its exit code (None: killed at
    the timeout) and its output."""
    index: int
    returncode: Optional[int]
    stdout: str
    stderr: str


def free_port() -> int:
    """A TCP port of the loopback that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_copy(raw: dict, processes: int, dp: int) -> dict:
    """A copy of the config ``raw`` (a dict, as read) that a launch of
    ``processes`` processes serves: every mesh stage (``mesh_devices``)
    homed on member 0 with one member a process (``mesh_devices`` 0 ..
    ``processes - 1``) factored as ``dp`` x ``processes / dp``, every
    other stage on the host (-1), which each process serves for itself
    (a stage on a card is one process's member, and another process could
    not serve it)."""
    out = copy.deepcopy(raw)
    for step in out["pipeline"]:
        mesh = "mesh_devices" in step
        if mesh:
            step.update(mesh_devices=list(range(processes)), dp=dp)
        for group in step["queue_groups"]:
            group["devices"] = [0 if mesh else -1] * len(group["devices"])
    return out


def launch(count: int, command: Sequence[str], timeout_s: float,
           env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
           env_of: Optional[Dict[int, Dict[str, str]]] = None
           ) -> List[Ended]:
    """Run ``command`` as processes ``0..count-1`` of one launch and wait
    for all of them; returns how each ended, in index order. ``env_of``
    adds variables to the processes it names by index. Every process
    still running at ``timeout_s``, or :data:`GRACE_S` after another
    failed, is killed and reported with returncode None."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs, outputs = [], []
    for index in range(count):
        child = dict(base, RNB_TPU_COORDINATOR="127.0.0.1:%d" % port,
                     RNB_TPU_NUM_PROCESSES=str(count),
                     RNB_TPU_PROCESS_ID=str(index),
                     **(env_of or {}).get(index, {}))
        # files, not pipes: a child that writes much never blocks on them
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        outputs.append((out, err))
        procs.append(subprocess.Popen(list(command), env=child, cwd=cwd,
                                      stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout_s
    failed_at = None
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.returncode not in (None, 0)
                                         for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None
                                  and now - failed_at > GRACE_S):
                break
            time.sleep(0.05)
    finally:
        killed = set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                killed.add(p.pid)
    ended = []
    for index, (p, (out, err)) in enumerate(zip(procs, outputs)):
        p.wait()
        texts = []
        for f in (out, err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        ended.append(Ended(index, None if p.pid in killed else p.returncode,
                           *texts))
    return ended


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-n", "--processes", type=int, default=2)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] \
        else args.command
    if not command:
        parser.error("no command to launch")
    ended = launch(args.processes, command, args.timeout)
    for e in ended:
        sys.stdout.write(e.stdout)
        sys.stderr.write(e.stderr)
        print("process %d: %s" % (e.index, "killed at the timeout"
                                  if e.returncode is None
                                  else "exit %d" % e.returncode),
              file=sys.stderr)
    return 0 if all(e.returncode == 0 for e in ended) else 1


if __name__ == "__main__":
    sys.exit(main())
