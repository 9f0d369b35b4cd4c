"""Worker-process transports: HOW the driver starts a worker (twin of
`ray_lightning_tpu/runtime/transport.py`).

The WorkerGroup decides WHAT to run (the worker loop, its rank, the
driver's listener address) and the transport decides how a process
running it appears. `LocalTransport` starts a subprocess on the driver's
machine. The cross-host transports (`SSHTransport`, `LoopbackTransport`)
are not ported yet and raise.

SECURITY: the driver⇄worker channel carries pickled jobs over TCP on
loopback, authenticated by a per-launch random 256-bit authkey (the
``multiprocessing.connection`` HMAC challenge) but not encrypted.
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, Optional

_WORKER_PATH = os.path.join(os.path.dirname(__file__), "worker.py")
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CROSS_HOST = ("ROADMAP Queue 1 item 14 (cross-host transports: "
               "SSHTransport, LoopbackTransport)")


class Transport:
    """Spawn one worker process; returns a ``subprocess.Popen``."""

    is_remote = False

    def spawn(self, *, host: Optional[str], connect: tuple,
              env: Dict[str, str], authkey_hex: str,
              log_path: str) -> subprocess.Popen:
        raise NotImplementedError


class LocalTransport(Transport):
    """Workers as plain subprocesses of the driver. The repository root
    leads the worker's ``PYTHONPATH``, so jobs and factories shipped by
    reference (`pickle`) resolve from any directory the driver ran in."""

    def spawn(self, *, host, connect, env, authkey_hex, log_path):
        driver_host, port, rank, world = connect
        wenv = dict(os.environ)
        wenv.update(env)
        wenv["RLT_WORKER_AUTHKEY"] = authkey_hex
        wenv["PYTHONPATH"] = (
            _REPO_ROOT + os.pathsep + wenv.get("PYTHONPATH", ""))
        with open(log_path, "w") as logf:
            return subprocess.Popen(
                [sys.executable, "-u", _WORKER_PATH,
                 driver_host, str(port), str(rank), str(world)],
                env=wenv, stdout=logf, stderr=subprocess.STDOUT)


class SSHTransport(Transport):
    """Workers on remote hosts over ssh: not ported yet."""

    is_remote = True

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"SSHTransport is not ported yet "
                                  f"({_CROSS_HOST})")


class LoopbackTransport(SSHTransport):
    """The SSH bootstrap path run locally: not ported yet."""
